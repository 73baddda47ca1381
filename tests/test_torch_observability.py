"""The observability the engine reports into: grove_tpu_torch's metrics
registry, span tracer and decision log against the JAX package's.

- `MetricsRegistry`: the same seeded sequence of counter, gauge and
  histogram operations on both packages' registries gives the same
  Prometheus exposition text, byte for byte.
- `Tracer`: the same nested spans and points give the same dump, except
  the times (v0/v1, t0/t1).
- The engine: the same solve sequence through the JAX engine and the
  port's (on the CPU, the kernels' plain versions), each with a registry,
  a tracer and a decision log: a full upload, the reuse tier, a staged
  delta into the fused program, an incremental tick, an adopted dispatch,
  a what-if, the split engine's delta scatter, and a hierarchical solve
  whose wave is at least 2 wide (then its memo and an adopted dispatch).
  Required, exactly: equal counter and gauge values by label; equal
  observations of the placement-score histogram and equal observation
  counts of the wall histograms; the same spans and points in the same
  order with equal attributes other than times and the process-global
  causal tokens (a point links its round's token in each package); the
  engine.fine_solve points in domain order; equal decision records (their
  wall clock aside). The counter values that differ by design are the
  transport bytes of kinds `inputs` and `whatif`: each engine counts the
  io buffers it really ships, and the port's layout (a deduped demand
  table) is its own. For them the port's counts are held to the bytes
  its host-to-device copies moved, and the state, mask and result bytes
  to the JAX engine's.
This mirrors TestObservability and the metrics case of TestIncremental in
tests/test_device_state.py.
"""

import numpy as np
import pytest

from grove_tpu.observability import metrics as jax_metrics
from grove_tpu.observability import tracing as jax_tracing
from grove_tpu.observability.explain import DecisionLog as JaxDecisionLog
from grove_tpu.solver import PlacementEngine as JaxEngine

from grove_tpu_torch.observability import (
    NOOP_TRACER,
    DecisionLog,
    MetricsRegistry,
    Tracer,
)
from grove_tpu_torch.observability import metrics, tracing
from grove_tpu_torch.solver import PlacementEngine
from test_solver import cluster, gang
from test_torch_device_state import port_gang, port_snapshot
from test_hierarchy import spread_problem

TIME_KEYS = ("v0", "v1", "t0", "t1")


# -- the registry and the tracer on their own ----------------------------------


def registry_ops(mod, seed: int):
    """A seeded sequence of registry operations on package `mod`'s
    metrics module; returns the exposition text."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for _ in range(60):
        op = int(rng.integers(0, 3))
        label = {"kind": str(rng.choice(["a", "b", 'q"uote', "n\nl"]))}
        if rng.random() < 0.3:
            label = {}
        if op == 0:
            reg.counter("grove_c_total", "a counter\\ help").inc(
                float(rng.integers(0, 5)), **label)
        elif op == 1:
            reg.gauge("grove_g", "a gauge").set(float(rng.normal()), **label)
        else:
            reg.histogram("grove_h_seconds", "a summary").observe(
                float(rng.exponential()), **label)
    return reg.render()


@pytest.mark.parametrize("seed", range(3))
def test_exposition_text_matches_the_jax_package(seed):
    assert registry_ops(metrics, seed) == registry_ops(jax_metrics, seed)


def tracer_ops(mod):
    """Nested spans, attributes set on exit, a point and an error span on
    package `mod`'s tracer; returns its dump without times."""
    tr = mod.Tracer()
    with tr.span("outer", gangs=3) as sp:
        with tr.span("inner", kind="delta"):
            tr.point("mark", domain=1)
        sp.set(path="fused", fallbacks=0)
    with pytest.raises(ValueError):
        with tr.span("failing"):
            raise ValueError("boom")
    assert mod.NOOP_TRACER.span("x") is mod.NOOP_TRACER.span("y")
    dump = tr.dump()
    for sp in dump["spans"]:
        for k in TIME_KEYS:
            sp.pop(k)
    return dump


def test_tracer_dump_matches_the_jax_package():
    assert tracer_ops(tracing) == tracer_ops(jax_tracing)


# -- the engine ---------------------------------------------------------------


def hooked(engine_cls, snap, tracer_cls, registry_cls, log_cls, **knobs):
    """An engine of either package with a fresh registry, tracer and
    decision log."""
    return engine_cls(snap, metrics=registry_cls(), tracer=tracer_cls(),
                      decision_log=log_cls(), **knobs)


class Pair:
    """The JAX engine and the port's on one cluster with the same knobs,
    each hooked, driven through the same calls."""

    def __init__(self, snap, **knobs):
        self.jsnap, self.tsnap = snap, port_snapshot(snap)
        self.j = hooked(JaxEngine, snap, jax_tracing.Tracer,
                        jax_metrics.MetricsRegistry, JaxDecisionLog, **knobs)
        self.t = hooked(PlacementEngine, self.tsnap, Tracer, MetricsRegistry,
                        DecisionLog, device="cpu", **knobs)
        self._port = {}
        self.h2d_bytes = 0
        orig = self.t._h2d

        def h2d(arr):
            self.h2d_bytes += np.asarray(arr).nbytes
            return orig(arr)

        self.t._h2d = h2d

    def gangs(self, gangs):
        out = []
        for g in gangs:
            if id(g) not in self._port:
                self._port[id(g)] = port_gang(g)
            out.append(self._port[id(g)])
        return out

    def solve(self, gangs, free, handles=(None, None)):
        rj = self.j.solve(gangs, free=free.copy(), dispatch=handles[0])
        rt = self.t.solve(self.gangs(gangs), free=free.copy(),
                          dispatch=handles[1])
        assert sorted(rj.placed) == sorted(rt.placed)
        return rt

    def dispatch(self, gangs, free):
        return (self.j.dispatch(gangs, free=free.copy()),
                self.t.dispatch(self.gangs(gangs), free=free.copy()))

    def note(self, rows):
        self.j.note_free_rows(rows)
        self.t.note_free_rows(rows)

    def whatif(self, gangs, free_rows):
        a = self.j.whatif_scores(gangs, free_rows=free_rows)
        b = self.t.whatif_scores(self.gangs(gangs), free_rows=free_rows)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def metric_values(reg) -> dict:
    """name -> (type, {labels: value}) for counters and gauges, and for
    histograms {labels: observations} (score) or {labels: count} (walls)."""
    out = {}
    for name, m in reg._metrics.items():
        kind = type(m).__name__
        if kind in ("Counter", "Gauge"):
            out[name] = (kind, dict(m._values))
        elif name.endswith("_seconds"):
            out[name] = (kind, dict(m._counts))
        else:
            out[name] = (kind, {k: sorted(m._obs_for(dict(k)))
                                for k in m._series})
    return out


def span_view(tracer) -> list:
    """(name, parent's name, attributes) of every finished span in order,
    without the times and the causal tokens."""
    by_id = {sp.span_id: sp.name for sp in tracer.finished}
    return [(sp.name, by_id.get(sp.parent_id),
             {k: v for k, v in sp.attrs.items()
              if not k.endswith("_seconds") and not k.startswith("causal_")})
            for sp in tracer.finished]


def decisions(log) -> dict:
    """Every gang's records without their wall clock."""
    out = {}
    for key, ring in log._rings.items():
        recs = []
        for r in ring:
            d = r.to_dict()
            d.pop("wall_time")
            recs.append(d)
        out[key] = recs
    return out


def assert_same_observations(pair: Pair) -> None:
    mj, mt = metric_values(pair.j.metrics), metric_values(pair.t.metrics)
    bytes_name = "grove_solver_transport_bytes_total"
    io_kinds = ((("kind", "inputs"),), (("kind", "whatif"),))
    tb_j = dict(mj.get(bytes_name, ("Counter", {}))[1])
    tb_t = dict(mt.get(bytes_name, ("Counter", {}))[1])
    # the io buffers' kinds: present alike, and the port's counts are what
    # its host-to-device copies moved (io buffers, masks, delta blocks)
    h2d_kinds = io_kinds + ((("kind", "masks"),), (("kind", "state_delta"),))
    assert sum(tb_t.get(k, 0.0) for k in h2d_kinds) == pair.h2d_bytes
    for k in io_kinds:
        assert (k in tb_j) == (k in tb_t)
        tb_j.pop(k, None)
        tb_t.pop(k, None)
    assert tb_t == tb_j
    mj.pop(bytes_name, None)
    mt.pop(bytes_name, None)
    assert mt == mj
    assert span_view(pair.t.tracer) == span_view(pair.j.tracer)
    assert decisions(pair.t.decisions) == decisions(pair.j.decisions)


def bench_gangs(n, start=0):
    return [gang(f"g{i:03d}", pods=2, cpu=2.0) for i in range(start, start + n)]


class TestFlatEngine:
    def test_solve_sequence_matches_the_jax_engine(self):
        """Full upload, reuse, staged delta, incremental tick, an adopted
        dispatch and a what-if: equal counters, spans and decisions."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        pair = Pair(snap)
        gangs = bench_gangs(5)
        free = snap.free.copy()
        pair.solve(gangs, free)                       # full upload, fused
        pair.solve(gangs, free)                       # reuse
        free2 = free.copy()
        free2[5] -= 1.0
        pair.note((5,))
        pair.solve(gangs, free2)                      # staged delta
        gangs2 = [gang("h0", pods=2, cpu=2.0)] + gangs[1:]
        res = pair.solve(gangs2, free2)               # incremental
        assert res.stats.get("incremental") == 1.0
        handles = pair.dispatch(gangs2 + [gang("h1", pods=3, cpu=1.0)], free2)
        assert pair.solve(handles[0].order, free2,
                          handles).stats.get("dispatch_overlap") == 1.0
        pair.whatif(gangs2, {3: snap.free[3] * 0.5})
        assert_same_observations(pair)
        ups = pair.t.metrics.counter("grove_solver_state_uploads_total")
        assert ups.value(kind="full") == 1.0 and ups.value(kind="delta") >= 1
        disp = pair.t.metrics.counter("grove_solver_dispatches_total")
        assert disp.value(kind="incremental") >= 1
        assert disp.value(kind="whatif") == 1
        names = {s[0] for s in span_view(pair.t.tracer)}
        assert {"engine.fused", "engine.delta_apply", "engine.whatif"} <= names
        assert len(pair.t.decisions) == 7

    def test_split_engine_spans_and_delta_scatter(self):
        """fused=False: the engine.encode / engine.device / engine.repair
        spans and the delta scatter's bytes, equal to the JAX engine's."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        pair = Pair(snap, fused=False)
        gangs = bench_gangs(4)
        free = snap.free.copy()
        pair.solve(gangs, free)
        free[2] -= 1.0
        pair.note((2,))
        pair.solve(gangs, free)
        assert_same_observations(pair)
        names = [s[0] for s in span_view(pair.t.tracer)]
        for n in ("engine.encode", "engine.device", "engine.repair"):
            assert names.count(n) == 2
        tb = pair.t.metrics.counter("grove_solver_transport_bytes_total")
        assert tb.value(kind="state_delta") > 0

    def test_incremental_metrics_and_debug_summary(self):
        """The metrics case of TestIncremental: one fused launch, one
        incremental launch of one dirty row, one reuse hit, and the
        decision-log entry of debug_summary."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        pair = Pair(snap)
        gangs = bench_gangs(5)
        pair.solve(gangs, snap.free)
        pair.solve(gangs, snap.free)
        gangs = [gang("h0", pods=2, cpu=2.0)] + gangs[1:]
        pair.solve(gangs, snap.free)
        assert_same_observations(pair)
        disp = pair.t.metrics.counter("grove_solver_dispatches_total")
        assert disp.value(kind="fused") == 1.0
        assert disp.value(kind="incremental") == 1.0
        rows = pair.t.metrics.counter("grove_solver_incremental_rows_total")
        assert rows.total() == 1.0
        ds = pair.t.debug_summary()
        assert ds["decisions"] == pair.j.debug_summary()["decisions"]
        assert ds["decisions"] == {"gangs_tracked": 6, "records_total": 15}

    def test_no_hooks_record_nothing(self):
        """Without hooks the engine keeps no registry and the no-op
        tracer, and `decisions = None` turns recording off."""
        snap = cluster()
        eng = PlacementEngine(port_snapshot(snap), device="cpu")
        assert eng.metrics is None and eng.tracer is NOOP_TRACER
        assert isinstance(eng.decisions, DecisionLog)
        eng.decisions = None
        eng.solve([port_gang(g) for g in bench_gangs(2)])
        assert eng.debug_summary()["decisions"] is None


class TestHierarchicalEngine:
    def test_wave_sequence_matches_the_jax_engine(self):
        """A hierarchical solve whose wave is at least 2 wide (4 workers),
        its repeat (the domain memo) and an adopted dispatch: equal
        counters (the wave histogram and gauge included), spans and
        points, decisions; the fine-solve points in domain order on the
        calling thread, linked to their round's token."""
        snap, free, gangs = spread_problem()
        pair = Pair(snap, hierarchical=True, hier_parallel_workers=4)
        res = pair.solve(gangs, free)
        assert res.stats["hier_wave_width"] >= 2
        assert res.stats["hier_wave_workers"] >= 2
        pair.solve(gangs, free)
        handles = pair.dispatch(gangs, free)
        assert pair.solve(gangs, free, handles).stats.get("dispatch_overlap")
        assert_same_observations(pair)
        spans = list(pair.t.tracer.finished)
        waves = [s for s in spans if s.name == "engine.hier_wave"]
        assert waves and max(s.attrs["workers"] for s in waves) >= 2
        hier = [s for s in spans if s.name == "engine.hierarchical"]
        assert len(hier) == 4  # two solves, the dispatch, the adoption
        for h in hier:
            fine = [s for s in spans if s.name == "engine.fine_solve"
                    and s.attrs["causal_link"] == h.attrs["causal_emit"]]
            doms = [s.attrs["domain"] for s in fine]
            assert doms == sorted(doms)
        assert any(s.name == "engine.fine_solve" for s in spans)
        hist = pair.t.metrics.histogram("grove_solver_hier_wave_seconds")
        assert hist.count > 0
        # the sub-engines have neither hooks nor a decision ring
        for shard in pair.t._hier.shards.values():
            if shard.engine is not None:
                assert shard.engine.metrics is None
                assert shard.engine.tracer is NOOP_TRACER
                assert shard.engine.decisions is None
