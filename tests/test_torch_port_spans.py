"""The port's own spans and the store's charges (tracing.PORT_SPANS).

- Structure: on a traced Harness each settle is one `harness.settle`;
  each leader round one `manager.round` under it, with one
  `manager.drain_events` and one `manager.flush_writes`, the reconciles
  between them; each kubelet tick one `kubelet.tick` under the settle
  with one `kubelet.heartbeat`; each engine solve one `engine.finish`
  with one `engine.record`, and `result.stats["finish_seconds"]` on the
  flat and the hierarchical path; each hierarchical solve one
  `engine.hier_coarse` and one `engine.hier_net` under its
  `engine.hierarchical`, full mode only; its `encode_seconds`,
  `device_seconds` and `repair_seconds` the sums of its sub-engines' own,
  and its `finish_seconds` theirs plus its own tail.
- Diagnoses: a solve's tail counts the diagnose_unplaced calls it ran
  (`diagnoses`), which the benchmark's diagnoses_per_solve reads; a
  sub-engine runs none and hands the gangs its block could not hold back
  to the parent, which each `engine.hier_wave` counts as `failures`.
- The net's short gangs: the repair counts the gangs its exactness net
  turned away on the free aggregate (`repair_net_short`, on the
  engine.fused span and each engine.fine_solve point); a hierarchical
  result sums its fine solves', and the benchmark's net_short_per_solve
  reads it.
- The store: each outermost call of a charged entry point adds to the
  innermost open span's `store_seconds` / `store_calls`, or is a
  `store.call` span where none is open; the charges equal a counting
  wrapper's tally of the outermost calls, and nested calls count once.
- Off and aggregate: no Span is allocated with tracing off, the store's
  methods are the class's own, and the aggregate tracer hands back the
  no-op span for every port span.
- The ring counts what it evicts; the wall clock is torch.profiler's.
"""

from __future__ import annotations

import time
from collections import Counter

import pytest

from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import (
    Container, PodCliqueSet, PodCliqueSetSpec, PodCliqueSetTemplateSpec,
    PodCliqueSpec, PodCliqueTemplateSpec, PodSpec)
from grove_tpu_torch.cluster import make_nodes
from grove_tpu_torch.cluster import store as store_mod
from grove_tpu_torch.cluster.store import CHARGED_OPS, ObjectStore
from grove_tpu_torch.controller import Harness
from grove_tpu_torch.observability import tracing
from grove_tpu_torch.observability.tracing import (
    NOOP_TRACER, PORT_SPANS, AggregateTracer, Tracer)


def pcs(name: str, replicas: int = 1, pods: int = 2) -> PodCliqueSet:
    return PodCliqueSet(
        metadata=ObjectMeta(name=name),
        spec=PodCliqueSetSpec(
            replicas=replicas,
            template=PodCliqueSetTemplateSpec(cliques=[PodCliqueTemplateSpec(
                name="w", spec=PodCliqueSpec(
                    replicas=pods, pod_spec=PodSpec(containers=[Container(
                        name="m", resources={"cpu": 1.0})])))])))


def traced(mode: str = "full", nodes: int = 8) -> Harness:
    return Harness(nodes=make_nodes(nodes), device="cpu",
                   config={"tracing": {"enabled": True, "mode": mode}})


@pytest.fixture(scope="module")
def settled():
    """A traced harness after three settles (the last with nothing to
    do), its spans, and the number of settles."""
    h = traced()
    h.apply(pcs("a", replicas=2))
    h.settle()
    h.apply(pcs("b"))
    h.clock.advance(1.0)
    h.settle()
    h.settle()
    return h, list(h.cluster.tracer.finished), 3


def by_id(spans):
    return {sp.span_id: sp for sp in spans}


def named(spans, name):
    return [sp for sp in spans if sp.name == name]


def parent_name(spans, sp):
    up = by_id(spans).get(sp.parent_id)
    return None if up is None else up.name


def children(spans, sp, name):
    return [c for c in spans if c.parent_id == sp.span_id and c.name == name]


# -- structure ------------------------------------------------------------------


def test_one_settle_span_a_settle_at_the_root(settled):
    _h, spans, n = settled
    settles = named(spans, "harness.settle")
    assert len(settles) == n
    assert all(sp.parent_id is None for sp in settles)


def test_a_round_is_under_its_settle(settled):
    _h, spans, _n = settled
    rounds = named(spans, "manager.round")
    assert rounds
    assert {parent_name(spans, sp) for sp in rounds} == {"harness.settle"}
    assert any(sp.attrs["batch"] > 0 for sp in rounds)


@pytest.mark.parametrize("child", ["manager.drain_events",
                                   "manager.flush_writes"])
def test_each_round_has_one_drain_and_one_flush(settled, child):
    _h, spans, _n = settled
    rounds = named(spans, "manager.round")
    for sp in rounds:
        assert len(children(spans, sp, child)) == 1
    assert len(named(spans, child)) == len(rounds)


def test_drain_and_flush_carry_their_counts(settled):
    _h, spans, _n = settled
    drains = named(spans, "manager.drain_events")
    assert sum(sp.attrs["events"] for sp in drains) > 0
    assert sum(sp.attrs["enqueued"] for sp in drains) > 0
    assert all(sp.attrs["writes"] >= 0
               for sp in named(spans, "manager.flush_writes"))


def test_reconciles_run_between_drain_and_flush(settled):
    _h, spans, _n = settled
    for sp in named(spans, "manager.reconcile"):
        assert parent_name(spans, sp) == "manager.round"
        (drain,) = children(spans, by_id(spans)[sp.parent_id],
                            "manager.drain_events")
        (flush,) = children(spans, by_id(spans)[sp.parent_id],
                            "manager.flush_writes")
        assert drain.t1 <= sp.t0 and sp.t1 <= flush.t0


def test_a_tick_is_under_its_settle_with_one_heartbeat(settled):
    _h, spans, _n = settled
    ticks = named(spans, "kubelet.tick")
    assert ticks
    assert {parent_name(spans, sp) for sp in ticks} == {"harness.settle"}
    for sp in ticks:
        assert len(children(spans, sp, "kubelet.heartbeat")) == 1
    assert len(named(spans, "kubelet.heartbeat")) == len(ticks)


def test_the_heartbeat_counts_leases_created_then_renewed(settled):
    h, spans, _n = settled
    beats = named(spans, "kubelet.heartbeat")
    nodes = len(h.kubelet._nodes)
    # the first tick creates one lease a node; the clock's advance renews
    # each once more; ticks at one instant write nothing
    assert sum(sp.attrs["created"] for sp in beats) == nodes
    assert sum(sp.attrs["renewed"] for sp in beats) == nodes
    assert sum(sp.attrs["created"] + sp.attrs["renewed"] == 0
               for sp in beats) == len(beats) - 2


def test_the_tick_counts_pods_started_readied_lost(settled):
    h, spans, _n = settled
    ticks = named(spans, "kubelet.tick")
    pods = len(h.store.scan("Pod"))
    assert sum(sp.attrs["started"] for sp in ticks) == pods
    assert sum(sp.attrs["readied"] for sp in ticks) == pods
    assert sum(sp.attrs["lost"] for sp in ticks) == 0
    points = named(spans, "kubelet.pod_start")
    assert len(points) == pods
    assert {parent_name(spans, sp) for sp in points} == {"kubelet.tick"}


def test_a_solve_has_one_finish_with_one_record(settled):
    _h, spans, _n = settled
    # a pre_round dispatch is an engine.fused span too, with no tail
    fused = [sp for sp in named(spans, "engine.fused")
             if not sp.attrs.get("dispatch")]
    finishes = named(spans, "engine.finish")
    assert fused and len(finishes) == len(fused)
    for f, sp in zip(fused, finishes):
        assert sp.parent_id == f.parent_id and f.t1 <= sp.t0
        assert len(children(spans, sp, "engine.record")) == 1
    assert len(named(spans, "engine.record")) == len(finishes)


def test_every_port_span_ran(settled):
    _h, spans, _n = settled
    # the settle's engine solves flat; the hierarchy's spans come from a
    # hierarchical solve
    _res, hier_spans = finish_stats(True)
    assert PORT_SPANS <= {sp.name for sp in spans + hier_spans}


def finish_stats(hierarchical: bool, tracer=None, gangs: int = 2):
    from test_hierarchy import make_cluster, make_gang
    from test_torch_hierarchy import port_gangs, port_snapshot

    from grove_tpu_torch.solver import PlacementEngine

    snap = port_snapshot(make_cluster(128))
    tracer = Tracer() if tracer is None else tracer
    engine = PlacementEngine(snap, device="cpu", tracer=tracer,
                             hierarchical=hierarchical)
    backlog = port_gangs([make_gang(f"g{i}", pods=8, cpu=16.0)
                          for i in range(gangs)] if gangs > 2
                         else [make_gang("a"), make_gang("b")])
    res = engine.solve(backlog, free=snap.free.copy())
    return res, list(tracer.finished)


@pytest.mark.parametrize("hierarchical", [False, True])
def test_finish_seconds_on_both_paths(hierarchical):
    res, spans = finish_stats(hierarchical)
    assert bool(res.stats.get("hierarchical")) is hierarchical
    assert res.num_placed == 2
    (fin,) = [sp for sp in spans if sp.name == "engine.finish"
              and sp.parent_id is None]
    assert 0.0 < res.stats["finish_seconds"] <= 1.0
    # the stat is timed around the span
    assert fin.t1 - fin.t0 <= res.stats["finish_seconds"]
    assert len(children(spans, fin, "engine.record")) == 1


HIER_SPANS = ("engine.hier_coarse", "engine.hier_net")


def test_the_hierarchy_has_one_coarse_and_one_net_span_a_solve():
    res, spans = finish_stats(True, gangs=24)
    (top,) = named(spans, "engine.hierarchical")
    for name in HIER_SPANS:
        (sp,) = named(spans, name)
        assert sp.parent_id == top.span_id
        assert top.t0 <= sp.t0 <= sp.t1 <= top.t1
    coarse, net = (named(spans, n)[0] for n in HIER_SPANS)
    assert coarse.attrs["gangs"] == 24 and coarse.attrs["domains"] == 2
    assert coarse.attrs["admissible"] + coarse.attrs["pruned"] == 24 * 2
    assert net.attrs["gangs"] == res.stats["fallbacks"]
    # the stats are timed around the spans
    assert coarse.t1 - coarse.t0 <= res.stats["hier_coarse_seconds"]
    assert net.t1 - net.t0 <= res.stats["hier_net_seconds"]
    waves = named(spans, "engine.hier_wave")
    assert waves and coarse.t1 <= waves[0].t0 and waves[-1].t1 <= net.t0
    # the waves' fine solves handed back every gang they failed: the
    # first block holds 16 of the 24 gangs
    assert sum(w.attrs["failures"] for w in waves) == 8


def test_the_hierarchy_spans_are_full_mode_only():
    tracer = AggregateTracer()
    for name in HIER_SPANS:
        assert tracer.span(name) is NOOP_TRACER.span(name)
    made = []
    span = tracer.span

    def spy(name, **attrs):
        sp = span(name, **attrs)
        if sp is not NOOP_TRACER.span(name):
            made.append(name)
        return sp

    tracer.span = spy
    res, _spans = finish_stats(True, tracer=tracer, gangs=24)
    assert res.stats["hierarchical"] == 1.0
    assert "engine.hierarchical" in made
    assert not set(HIER_SPANS) & set(made)


def recording_sub_engines(monkeypatch) -> list:
    """Every sub-engine's results, in the order its solves return."""
    from grove_tpu_torch.solver import PlacementEngine

    results = []
    make = PlacementEngine._make_sub_engine

    def recorded(self, shard):
        sub = make(self, shard)
        solve = sub.solve

        def kept(*a, **k):
            res = solve(*a, **k)
            results.append(res)
            return res

        sub.solve = kept
        return sub

    monkeypatch.setattr(PlacementEngine, "_make_sub_engine", recorded)
    return results


def test_sub_engine_sums_equal_the_sub_engines_own_stats(monkeypatch):
    results = recording_sub_engines(monkeypatch)
    res, _spans = finish_stats(True, gangs=24)
    subs = [r.stats for r in results]
    assert res.stats["hierarchical"] == 1.0
    assert len(subs) == res.stats["hier_fine_solves"] >= 2
    for part in ("encode", "device", "repair"):
        total = 0.0
        for st in subs:
            total += st[f"{part}_seconds"]
        assert res.stats[f"{part}_seconds"] == total > 0.0
    sub_finish = 0.0
    for st in subs:
        sub_finish += st["finish_seconds"]
    (fin,) = [sp for sp in _spans if sp.name == "engine.finish"]
    # the solve's own tail, timed around its span, on top of the fine
    # solves' tails
    assert (sub_finish + (fin.t1 - fin.t0) <= res.stats["finish_seconds"]
            < sub_finish + 1.0)
    # the collect halves run in turn on the calling thread, inside the
    # waves' wall
    assert (res.stats["device_seconds"] + res.stats["repair_seconds"]
            + sub_finish <= res.stats["hier_fine_seconds"])
    # the sub-engines ran no diagnosis and handed back the gangs their
    # blocks could not hold, which the waves count
    assert all(st["diagnoses"] == 0.0 for st in subs)
    back = sum(len(r.unplaced) for r in results)
    waves = [sp for sp in _spans if sp.name == "engine.hier_wave"]
    assert back == sum(w.attrs["failures"] for w in waves) > 0


@pytest.mark.parametrize("hierarchical", [False, True])
def test_the_tail_diagnoses_each_unplaced_gang_once(hierarchical,
                                                    monkeypatch):
    """`diagnoses` counts the diagnose_unplaced calls the solve's own tail
    ran: one an unplaced gang on a cold memo, none on a repeat that hits
    it, on a flat engine and on a hierarchical parent alike."""
    from test_hierarchy import make_cluster, make_gang
    from test_torch_hierarchy import port_gangs, port_snapshot

    from grove_tpu_torch.solver import PlacementEngine
    from grove_tpu_torch.solver import engine as engine_mod

    subs = recording_sub_engines(monkeypatch)
    snap = port_snapshot(make_cluster(128))
    engine = PlacementEngine(snap, device="cpu", hierarchical=hierarchical)
    # 17 whole hosts under a rack requirement: no rack of 16 holds one
    backlog = port_gangs([make_gang(f"g{i}", pods=8, cpu=16.0)
                          for i in range(6)]
                         + [make_gang(f"z{i}", pods=17, cpu=32.0, required=1)
                            for i in range(2)])
    first = engine.solve(backlog, free=snap.free.copy())
    again = engine.solve(backlog, free=snap.free.copy())
    assert bool(first.stats.get("hierarchical")) is hierarchical
    assert sorted(first.unplaced) == sorted(again.unplaced) == ["z0", "z1"]
    assert first.stats["diagnoses"] == 2.0
    assert again.stats["diagnoses"] == 0.0
    for name, reason in again.unplaced.items():
        assert reason is first.unplaced[name]
        assert reason is not engine_mod._LEFT_TO_PARENT
    # the sub-engines diagnosed nothing and handed gangs back
    assert bool(subs) is hierarchical
    assert all(r.stats["diagnoses"] == 0.0 for r in subs)
    if hierarchical:
        assert any(r.unplaced for r in subs)


def test_diagnoses_per_solve_reads_the_solves_counters():
    """The benchmark's diagnoses_per_solve metric: the mean over the
    window's solves of the tail's diagnoses plus the fine solves'; None
    for a program that counts none."""
    from benchmark import readers, run

    read = run._reader("diagnoses_per_solve")
    flat, _ = finish_stats(False)
    hier, _ = finish_stats(True, gangs=24)
    solves = [dict(flat.stats), dict(hier.stats),
              {"diagnoses": 3.0, "hier_sub_diagnoses": 6.0}]
    assert read(readers.TracedRun(solves=solves)) == 3.0
    assert read(readers.TracedRun(solves=[{"finish_seconds": 0.1}])) is None


def test_a_flat_solve_reports_its_nets_short_gangs_on_its_span():
    """40 gangs for the room of 32: the eight left over reach the net
    with the cluster's free short of them, and the count is on the
    result and on the engine.fused span."""
    res, spans = finish_stats(False, gangs=40)
    (fused,) = named(spans, "engine.fused")
    assert res.num_placed == 32 and res.stats["fallbacks"] == 8.0
    assert fused.attrs["repair_net_short"] == res.stats["repair_net_short"]
    assert res.stats["repair_net_short"] == 8.0


def test_the_parents_net_short_is_the_fine_solves_sum(monkeypatch):
    """24 gangs ranked onto a block that holds 16: its sub-engine hands
    back the 8 its net turned away on the free aggregate. The parent's
    `repair_net_short` is the sum of its fine solves', above 0 and at
    most their fallbacks, and each fine solve's engine.fine_solve point
    carries its own."""
    results = recording_sub_engines(monkeypatch)
    res, spans = finish_stats(True, gangs=24)
    subs = [r.stats["repair_net_short"] for r in results]
    assert res.stats["hierarchical"] == 1.0
    assert res.stats["repair_net_short"] == sum(subs)
    assert 0.0 < sum(subs) <= res.stats["hier_repair_fallbacks"]
    points = named(spans, "engine.fine_solve")
    assert [p.attrs["repair_net_short"] for p in points] == subs


def test_net_short_per_solve_reads_the_solves_counters():
    """The benchmark's net_short_per_solve metric: the mean over the
    window's solves of `repair_net_short`, flat and hierarchical alike;
    None for a program that counts none."""
    from benchmark import readers, run

    read = run._reader("net_short_per_solve")
    flat, _ = finish_stats(False, gangs=40)
    hier, _ = finish_stats(True, gangs=24)
    solves = [dict(flat.stats), dict(hier.stats), {"repair_net_short": 3.0}]
    want = (flat.stats["repair_net_short"] + hier.stats["repair_net_short"]
            + 3.0) / 3
    assert read(readers.TracedRun(solves=solves)) == want > 1.0
    assert read(readers.TracedRun(solves=[{"finish_seconds": 0.1}])) is None


# -- the store's charges ----------------------------------------------------------


class Tally:
    """Counts the outermost calls of the charged entry points, wrapped on
    the class before any store charges them."""

    def __init__(self, monkeypatch):
        self.calls = Counter()
        self.depth = 0
        for op in CHARGED_OPS:
            monkeypatch.setattr(ObjectStore, op,
                                self.wrap(op, getattr(ObjectStore, op)))

    def wrap(self, op, plain):
        def counted(store, *args, **kwargs):
            if self.depth == 0:
                self.calls[op] += 1
            self.depth += 1
            try:
                return plain(store, *args, **kwargs)
            finally:
                self.depth -= 1

        return counted


def charges(spans):
    calls = sum(sp.attrs.get("store_calls", 0) for sp in spans)
    return calls + sum(sp.name == "store.call" for sp in spans)


def test_charges_equal_the_tally_of_outermost_calls(monkeypatch):
    tally = Tally(monkeypatch)
    h = traced()
    # the cluster's own set-up (nodes, topology) is charged too
    assert charges(h.cluster.tracer.finished) == sum(tally.calls.values())
    tally.calls.clear()
    h.cluster.tracer.finished.clear()
    h.apply(pcs("a", replicas=2))
    h.settle()
    h.store.get("PodCliqueSet", "default", "a")
    spans = list(h.cluster.tracer.finished)
    assert charges(spans) == sum(tally.calls.values()) > 0
    ops = Counter(sp.attrs["op"] for sp in spans if sp.name == "store.call")
    assert ops["get"] >= 1 and ops["create"] >= 1


def test_store_seconds_lie_inside_the_span(settled):
    _h, spans, _n = settled
    charged = [sp for sp in spans if "store_seconds" in sp.attrs]
    assert charged
    for sp in charged:
        assert sp.attrs["store_calls"] >= 1
        assert 0.0 <= sp.attrs["store_seconds"] <= sp.t1 - sp.t0 + 1e-6


@pytest.mark.parametrize("op", ["list", "create"])
def test_a_nested_call_is_charged_once(op):
    """list runs scan; create runs the PodCliqueSet admission, whose
    webhooks may read the store: one call each."""
    h = traced()
    tracer = h.cluster.tracer
    with tracer.span("outer") as sp:
        if op == "list":
            h.store.list("Node")
        else:
            h.store.create(pcs("x"))
    assert sp.attrs["store_calls"] == 1
    assert sp.attrs["store_seconds"] > 0.0


def test_a_call_with_no_span_open_is_a_span_of_its_own():
    h = traced()
    tracer = h.cluster.tracer
    before = tracer.spans_started
    h.store.scan("Node")
    sp = tracer.finished[-1]
    assert (sp.name, sp.attrs, sp.parent_id) == ("store.call",
                                                 {"op": "scan"}, None)
    assert tracer.spans_started == before + 1


# -- off and aggregate --------------------------------------------------------------


def plain_methods(store) -> bool:
    return all(op not in vars(store)
               and getattr(store, op).__func__ is getattr(ObjectStore, op)
               for op in CHARGED_OPS)


def test_tracing_off_allocates_no_span_and_keeps_the_plain_store(monkeypatch):
    made = []
    init = tracing.Span.__init__

    def counting(self, *args, **kwargs):
        made.append(args[1])
        init(self, *args, **kwargs)

    monkeypatch.setattr(tracing.Span, "__init__", counting)
    h = Harness(nodes=make_nodes(8), device="cpu")
    assert h.cluster.tracer is NOOP_TRACER
    assert plain_methods(h.store)
    h.apply(pcs("a"))
    h.settle()
    assert made == []


def test_aggregate_mode_keeps_the_plain_store_and_drops_port_spans():
    h = traced("aggregate")
    tracer = h.cluster.tracer
    assert isinstance(tracer, AggregateTracer)
    assert plain_methods(h.store)
    for name in PORT_SPANS:
        assert tracer.span(name) is NOOP_TRACER.span(name)
    h.apply(pcs("a"))
    h.settle()
    assert tracer.folder.summary()


@pytest.mark.parametrize("name", sorted(PORT_SPANS))
def test_port_spans_fold_nothing(name):
    assert name not in AggregateTracer._FOLD_NAMES


# -- the ring and the clock ------------------------------------------------------------


def test_the_ring_counts_what_it_evicts():
    tracer = Tracer(max_spans=4)
    for i in range(6):
        with tracer.span("s"):
            pass
    tracer.point("p")
    assert tracer.dropped == 3
    assert tracer.summary()["dropped"] == 3
    assert [sp.span_id for sp in tracer.finished] == [4, 5, 6, 7]


def test_the_wall_clock_is_seconds_since_epoch_ns():
    tracer = Tracer()
    a = time.time_ns()
    with tracer.span("s") as sp:
        pass
    b = time.time_ns()
    assert a <= tracer.epoch_ns + sp.t0 * 1e9 + 1e3
    assert tracer.epoch_ns + sp.t1 * 1e9 <= b + 1e3


def test_the_epoch_is_where_perf_counter_reads_zero():
    tracer = Tracer()
    a = time.perf_counter()
    with tracer.span("s") as sp:
        pass
    b = time.perf_counter()
    # the real-time clock and perf_counter drift apart by parts a million
    assert a - 1e-3 <= sp.t0 <= sp.t1 <= b + 1e-3


def test_chrome_trace_places_a_tracer_on_the_unix_clock():
    tracer = Tracer()
    with tracer.span("s") as sp:
        pass
    (ev,) = [e for e in tracing.chrome_trace({"g": tracer})["traceEvents"]
             if e.get("ph") == "X" or e.get("ph") == "i"]
    assert ev["ts"] == pytest.approx((tracer.epoch_ns + sp.t0 * 1e9) / 1e3,
                                     abs=1.0)


def test_a_profiler_range_and_a_span_agree_through_epoch_ns():
    """A record_function range and a Tracer span opened back to back: the
    profiler's host timestamp of the range, on its own clock, lies between
    the Tracer's readings before the range and at the span's start,
    within 2 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = Tracer()
    probes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            before = tracer._now_t()
            with record_function(f"probe{i}"):
                with tracer.span(f"probe{i}") as sp:
                    probes.append((before, sp))
            time.sleep(0.02)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("probe")}
    for before, sp in probes:
        at_ns = start_ns + events[sp.name].time_range.start * 1e3
        lo = tracer.epoch_ns + before * 1e9 - 2e6
        hi = tracer.epoch_ns + sp.t0 * 1e9 + 2e6
        assert lo <= at_ns <= hi, (sp.name, (at_ns - lo) / 1e6,
                                   (hi - at_ns) / 1e6)


def test_charge_calls_module_names_every_op():
    assert set(CHARGED_OPS) <= {n for n in dir(store_mod.ObjectStore)}
    assert not {"peek", "kind_bucket"} & set(CHARGED_OPS)
