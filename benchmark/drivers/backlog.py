"""Rolling full backlogs against the placement engine (`PlacementEngine.solve`).

Set-up binds `held` backlogs, each a `backlog_share` of the cluster's pod
slots in the configuration's gang mix, then runs `warm_iterations` steps
of the loop below, which warm every shape the window uses. The window
then repeats, back to back (a closed loop: a scheduler takes the next
backlog when the last is bound), until `--seconds` have passed:

1. release the oldest bound backlog: its pods' demand goes back to the
   free state, and the engine is told which node rows changed;
2. draw a new backlog from the seed (the mix's exact proportions, a new
   order, new names);
3. solve it against the free state, which the solve commits to.

So every solve meets a backlog and a free state no earlier solve had.
After the window the reference replays the whole sequence on its own
free ledger (capacity less every pod the program reported bound), checks
every placement against the guarantees, and re-solves a sample of the
window's solves, drawn from the seed. Of a sampled solve the run keeps
what the solve handed its repair and, once the solve's wall is read, its
value tensor; of the others, nothing but the placements.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from .. import readers, reference, roofline, system
from ..deployment import deployment
from ..profile import DeviceTrace
from ..stats import quantile, rate
from .common import GcPauses, Outcome, release_device, sync


class _Draw:
    """Backlogs as the program's gangs, built on one spec a mix entry so
    the draw costs the window little; `specs` rebuilds a backlog for the
    reference after the window."""

    def __init__(self, dep):
        self.dep = dep
        self.templates = [dep.gang("", kind) for kind in dep.mix]

    def draw(self, rng, k: int, n: int):
        kinds = self.dep.draw_kinds(rng, n)
        return kinds, [system.solver_gang(self.templates[kind],
                                          f"b{k:05d}-{i:05d}")
                       for i, kind in enumerate(kinds)]

    def specs(self, k: int, kinds):
        return self.dep.backlog(f"b{k:05d}", kinds)


def run(config, traffic, limits, seed, seconds, trace, device=None,
        mark_window=lambda: None, base_engine=None) -> Outcome:
    from grove_tpu_torch.observability.tracing import Tracer
    from grove_tpu_torch.solver import programs
    from grove_tpu_torch.tuning import tune_gc

    dep = deployment(config)
    n = int(round(traffic["backlog_share"] * dep.slots() / dep.pods_per_gang()))
    held_max = traffic["held"]
    rng = np.random.default_rng(seed)
    drawer = _Draw(dep)
    snap = system.snapshot(dep)
    # the window solves the reference re-solves: enough to hold
    # `check_gangs` gangs, drawn from the seed
    recorder = system.Recorder(-(-traffic["check_gangs"] // n), seed)
    tracer = Tracer() if trace else None
    engine = system.engine_class(recorder, base_engine)(
        snap, tracer=tracer, **system.engine_kwargs(config, device))
    free = snap.free.copy()
    held: deque = deque()
    # (k, kinds, [G, P] nodes or -1, released k, in the window)
    log = []
    walls, placed, offered = [], 0, 0
    paths = {"fused": 0, "incremental": 0, "reused": 0, "hierarchical": 0}
    stats = []

    def step(k: int, window: bool, dt: DeviceTrace | None = None):
        nonlocal placed, offered
        released = None
        with (dt.range("bench.release") if dt else _null()):
            if len(held) >= held_max:
                released, rel_gangs, rel_res = held.popleft()
                rows = []
                for g in rel_gangs:
                    p = rel_res.placed.get(g.name)
                    if p is not None:
                        np.add.at(free, p.node_indices, g.demand)
                        rows.append(p.node_indices)
                if rows:
                    engine.note_free_rows(np.unique(np.concatenate(rows)).tolist())
        with (dt.range("bench.draw") if dt else _null()):
            kinds, gangs = drawer.draw(rng, k, n)
        with (dt.range("bench.solve") if dt else _null()):
            t0 = time.perf_counter()
            res = engine.solve(gangs, free)
            sync(device)
            wall = time.perf_counter() - t0
        if window:
            # the sampled solve's value tensor, outside its wall
            with (dt.range("bench.sample") if dt else _null()):
                recorder.take_value()
        held.append((k, gangs, res))
        nodes = np.full((len(gangs), gangs[0].num_pods), -1, np.int64)
        for i, g in enumerate(gangs):
            p = res.placed.get(g.name)
            if p is not None:
                nodes[i] = p.node_indices
        log.append((k, kinds, nodes, released, window))
        if window:
            walls.append(wall)
            placed += res.num_placed
            offered += len(gangs)
            stats.append(dict(res.stats))
            st = res.stats
            kind = ("hierarchical" if st.get("hierarchical") else
                    "reused" if st.get("reused") else
                    "incremental" if st.get("incremental") else "fused")
            paths[kind] += 1

    k = 0
    for _ in range(held_max + traffic["warm_iterations"]):
        step(k, False)
        k += 1
    tune_gc()
    caps0 = programs.capture_counts()
    gc_pauses = GcPauses()
    recorder.on = True
    dt = DeviceTrace(trace, tracer)
    mark_window()
    spans = []
    with dt, gc_pauses:
        t_end = dt.t0 + seconds
        while time.perf_counter() < t_end:
            step(k, True, dt if trace else None)
            k += 1
            if tracer is not None:
                # the tracer keeps a bounded ring: drain it every step
                spans.extend(tracer.finished)
                tracer.finished.clear()
    window_s = dt.window_s
    recorder.on = False
    caps = {p: c - caps0.get(p, 0) for p, c in programs.capture_counts().items()}
    out = Outcome()
    out.metrics = {
        "solve_gangs_per_s": rate(placed, window_s),
        "solve_p95_s": quantile(walls, 0.95),
    }
    out.attempted, out.failed = offered, offered - placed
    thirds = [walls[i * len(walls) // 3:(i + 1) * len(walls) // 3]
              for i in range(3)]
    out.notes += [
        f"window: {window_s:.3f} s, {len(walls)} solves of {n} gangs, "
        f"{placed} placed; solve wall median {quantile(walls, 0.5):.6f} s, "
        f"p95 {quantile(walls, 0.95):.6f} s; median by third of the window "
        + " / ".join(f"{quantile(t, 0.5):.6f}" for t in thirds if t),
        f"engine paths in the window: {paths}",
        f"graph captures in the window: {caps}",
        gc_pauses.note(),
    ]
    out.extra["paths"] = paths
    out.extra["captures_in_window"] = caps
    if trace:
        tr = dt.read(spans)
        shapes = _shapes(dep, config, drawer, log)
        out.traced = readers.TracedRun(
            solves=stats, kernels=tr["kernels"], busy_s=tr["busy_s"],
            window_s=window_s,
            least={role: (roofline.least_seconds(role, shapes), len(shapes))
                   for role in roofline.ROLES},
            bound=placed)
        out.trace = tr
    out.memory_peak_bytes = release_device(device)
    derived = recorder.values_from_inputs()
    if derived:
        out.notes.append(f"reference: the engine kept no value tensor; "
                         f"{derived} taken from score_values")
    engine.release()
    del engine, held
    out.checks = _judge(dep, config, drawer, log, recorder.records, limits,
                        out.notes)
    return out


def _shapes(dep, config, drawer, log) -> list:
    """One device-phase shape per window solve (one launch of each kernel
    a solve on the flat fused path)."""
    d = 1 + sum(len(set(row)) for row in dep.labels) + dep.num_nodes
    out = []
    for _k, kinds, _nodes, _rel, window in log:
        if not window:
            continue
        present = [drawer.templates[i] for i in set(kinds.tolist())]
        u = len({t.demand.max(axis=0).tobytes() for t in present})
        t = len({t.demand.sum(axis=0).tobytes() for t in present})
        out.append(roofline.Shape(g=len(kinds), d=d, r=len(dep.resources),
                                  u=u, s=1, t=t, k=config["engine"]["top_k"],
                                  l1=len(dep.labels) + 2))
    return out


def _judge(dep, config, drawer, log, records, limits, notes):
    """The checks: guarantee violations over every solve of the run, and
    the reference's re-solve of the sampled solves of the window."""
    topo = reference.Topology(dep.labels, dep.node_names, dep.capacity)
    by_k = {int(rec.order[0].name[1:6]): rec for rec in records if rec.order}
    ledger = dep.capacity.copy()
    placed_of = {}
    violations = 0
    gap, dom_mis, place_mis, checked = 0.0, 0, 0, 0
    e = config["engine"]
    t0 = time.perf_counter()
    for k, kinds, nodes, released, _w in log:
        if released is not None:
            rel_specs, rel_nodes = placed_of.pop(released)
            for spec, row in zip(rel_specs, rel_nodes):
                if row[0] >= 0:
                    np.add.at(ledger, row, spec.demand)
        specs = drawer.specs(k, kinds)
        assign = {s.name: row for s, row in zip(specs, nodes) if row[0] >= 0}
        rec = by_k.get(k)
        if rec is not None:
            c = reference.compare_solve(topo, ledger.copy(), specs,
                                        rec.top_val, rec.top_dom, rec.placed,
                                        rec.value, e["top_k"],
                                        e["commit_chunk"],
                                        [g.name for g in rec.order])
            gap = max(gap, c["value_gap"])
            dom_mis += c["domain_mismatch"]
            place_mis += c["placement_mismatch"]
            checked += c["gangs"]
        violations += reference.guarantee_violations(topo, ledger, specs, assign)
        placed_of[k] = (specs, nodes)
    notes.append(f"reference: {len(log)} solves checked for the guarantees, "
                 f"{len(by_k)} re-solved ({checked} gangs), "
                 f"{time.perf_counter() - t0:.1f} s")
    if not by_k:
        notes.append("reference: no sampled solve in the window")
        gap = 1e9
    return [("violations", violations, limits["violations"]),
            ("value_gap", gap, limits["value_gap"]),
            ("domain_mismatch", dom_mis, limits["domain_mismatch"]),
            ("placement_mismatch", place_mis, limits["placement_mismatch"])]


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
