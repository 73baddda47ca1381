"""Rolling full backlogs against the hierarchical solve (`PlacementEngine.solve`
with the hierarchy on).

The loop of `drivers/backlog.py`, with its backlog draw: set-up binds
`held` backlogs, each a `backlog_share` of the cluster's pod slots in the
configuration's gang mix; each step releases the oldest bound backlog
(its rows declared to the engine), draws a new one from the seed and
solves it against the free state, back to back. Set-up then runs
`warm_iterations` steps, and more until one whole solve makes no CUDA
graph capture in any sub-engine, at most `WARM_CAP` steps in all. On the
card the sub-engines go on capturing past the cap: a block's sub-engine
solves a few times a backlog and keeps meeting bucket keys it has not
captured yet. So the window is not a steady state and holds captures:
they are reported, with the graphs the sub-engines' LRUs evicted in it
(none on an H100 at the published sizes).

The step repeats `backlog.py`'s; only the warm-up, the paths and the
traced run's extras differ.

After the window the reference replays the whole sequence on its own
free ledger and checks every placement against the guarantees; of a
sample of the window's solves drawn from the seed (enough to hold
`check_gangs` gangs) it re-solves the two levels with
`reference_hier.compare_solve`: the coarse choices, and each fine solve's
value tensor, committed rows and placements.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from .. import (readers, reference, reference_hier, roofline, system,
               system_hier)
from ..deployment import deployment
from ..profile import DeviceTrace
from ..stats import quantile, rate
from .backlog import _Draw, _null
from .common import GcPauses, Outcome, release_device, sync


#: warm-up steps at most, the held backlogs included
WARM_CAP = 12


@dataclass
class TierRun(readers.TracedRun):
    """A traced tier run: also the graph captures in the window."""

    captures: int | None = None


def _captures() -> int:
    from grove_tpu_torch.solver import programs

    return sum(programs.capture_counts().values())


def run(config, traffic, limits, seed, seconds, trace, device=None,
        mark_window=lambda: None, base_engine=None) -> Outcome:
    from grove_tpu_torch.observability.tracing import Tracer
    from grove_tpu_torch.tuning import tune_gc

    dep = deployment(config)
    n = int(round(traffic["backlog_share"] * dep.slots() / dep.pods_per_gang()))
    held_max = traffic["held"]
    rng = np.random.default_rng(seed)
    drawer = _Draw(dep)
    snap = system.snapshot(dep)
    recorder = system_hier.HierRecorder(-(-traffic["check_gangs"] // n), seed)
    tracer = Tracer() if trace else None
    engine = system_hier.engine_class(recorder, base_engine)(
        snap, tracer=tracer, **system_hier.engine_kwargs(config, device))
    free = snap.free.copy()
    held: deque = deque()
    # (k, kinds, [G, P] nodes or -1, released k, in the window)
    log = []
    walls, placed, offered = [], 0, 0
    paths = {"hierarchical": 0, "flat": 0}
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
            # the sampled solve's value rows leave the card outside its wall
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
            paths["hierarchical" if res.stats.get("hierarchical")
                  else "flat"] += 1

    k = 0
    warm_caps, warm_walls = [], []
    while True:
        before, t0 = _captures(), time.perf_counter()
        step(k, False)
        k += 1
        warm_walls.append(time.perf_counter() - t0)
        warm_caps.append(_captures() - before)
        if k >= held_max + traffic["warm_iterations"] and (
                warm_caps[-1] == 0 or k >= WARM_CAP):
            break
    tune_gc()
    caps0, evicted0 = _captures(), recorder.evictions()
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
    caps, evicted = _captures() - caps0, recorder.evictions() - evicted0
    out = Outcome()
    out.metrics = {
        "solve_gangs_per_s": rate(placed, window_s),
        "solve_p95_s": quantile(walls, 0.95),
    }
    out.attempted, out.failed = offered, offered - placed
    out.notes += [
        f"window: {window_s:.3f} s, {len(walls)} solves of {n} gangs, "
        f"{placed} placed; solve walls "
        + ", ".join(f"{w:.6f}" for w in walls),
        f"engine paths in the window: {paths}",
        f"warm-up: {len(warm_caps)} steps, graph captures a step "
        f"{warm_caps}, step walls "
        + ", ".join(f"{w:.3f}" for w in warm_walls),
        f"graph captures in the window: {caps}; graphs the sub-engines "
        f"evicted: {evicted}",
        gc_pauses.note(),
    ]
    out.extra["paths"] = paths
    out.extra["warm_captures"] = warm_caps
    out.extra["captures_in_window"] = caps
    if trace:
        tr = dt.read(spans)
        shapes = _shapes(dep, config, drawer, log, recorder.fine_runs)
        out.traced = TierRun(
            solves=stats, kernels=tr["kernels"], busy_s=tr["busy_s"],
            window_s=window_s, spans=spans, bound=placed, captures=caps,
            least={role: (roofline.least_seconds(role, shapes[role]),
                          len(shapes[role])) for role in roofline.ROLES})
        out.trace = tr
        seen = {role: tr["kernels"].get(role, {}).get("launches", 0)
                for role in roofline.ROLES}
        out.notes.append(
            "kernel launches in the window, the profiler's / the fine "
            "solves' shapes: " + ", ".join(
                f"{role} {seen[role]} / {len(shapes[role])}"
                for role in roofline.ROLES))
    out.memory_peak_bytes = release_device(device)
    derived = recorder.values_from_inputs()
    if derived:
        out.notes.append(f"reference: the sub-engines kept no value tensor "
                         f"in {derived} fine solves; taken from score_values")
    engine.release()
    del engine, held
    out.checks = _judge(dep, config, drawer, log, recorder.records, limits,
                        out.notes)
    return out


def _shapes(dep, config, drawer, log, fine_runs) -> dict:
    """Each role's device-phase shapes, one a launch: one a fine solve of
    the window that launched (the reuse tier launches nothing), two where
    its dispatch captured a graph (the program's eager run, then the
    replay), on its block's sub-topology. K1 computes every row on the
    full path and the dirty rows alone on the incremental one; K2 and K3
    every row."""
    hier = reference_hier.Hierarchy(dep.labels, dep.node_names, dep.capacity)
    first = next((kk, kinds) for kk, kinds, _n, _r, w in log if w)
    level = reference_hier.prune_level(
        hier.topo, drawer.specs(*first),
        config["engine"].get("hier_min_nodes", 0))
    out = {role: [] for role in roofline.ROLES}
    for dom, gangs, st, captured in fine_runs:
        if st.get("reused"):
            continue
        _rows, sub = hier.domain(level, dom)
        u = len({g.demand.max(axis=0).tobytes() for g in gangs})
        t = len({g.demand.sum(axis=0).tobytes() for g in gangs})
        full = roofline.Shape(g=len(gangs), d=sub.num_domains,
                              r=len(dep.resources), u=u, s=1, t=t,
                              k=config["engine"]["top_k"],
                              l1=sub.anc.shape[1])
        dirty = (int(st.get("incremental_rows", 0))
                 if st.get("incremental") else len(gangs))
        for _run in range(1 + min(captured, 1)):
            out["k1"].append(replace(full, g=dirty))
            out["k2"].append(full)
            out["k3"].append(full)
    return out


def _judge(dep, config, drawer, log, records, limits, notes):
    """The checks: guarantee violations over every solve of the run, and
    the reference's two-level re-solve of the sampled solves."""
    hier = reference_hier.Hierarchy(dep.labels, dep.node_names, dep.capacity)
    topo = hier.topo
    by_k = {int(rec.order[0].name[1:6]): rec for rec in records if rec.order}
    ledger = dep.capacity.copy()
    placed_of = {}
    violations = 0
    sums = dict.fromkeys(("coarse_mismatch", "domain_mismatch",
                          "placement_mismatch", "gangs", "fine_solves",
                          "net"), 0)
    gap = 0.0
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
            c = reference_hier.compare_solve(
                hier, ledger, specs, rec.fines, assign, e["top_k"],
                e["commit_chunk"], e.get("hier_min_nodes", 0))
            gap = max(gap, c["value_gap"])
            for key in sums:
                sums[key] += c[key]
        violations += reference.guarantee_violations(topo, ledger, specs, assign)
        placed_of[k] = (specs, nodes)
    notes.append(f"reference: {len(log)} solves checked for the guarantees, "
                 f"{len(by_k)} re-solved ({sums['gangs']} gangs, "
                 f"{sums['fine_solves']} fine solves, {sums['net']} gangs "
                 f"to the net), {time.perf_counter() - t0:.1f} s")
    if not by_k:
        notes.append("reference: no sampled solve in the window")
        gap = 1e9
        sums["coarse_mismatch"] = 1e9
    return [("violations", violations, limits["violations"]),
            ("coarse_mismatch", sums["coarse_mismatch"],
             limits["coarse_mismatch"]),
            ("value_gap", gap, limits["value_gap"]),
            ("domain_mismatch", sums["domain_mismatch"],
             limits["domain_mismatch"]),
            ("placement_mismatch", sums["placement_mismatch"],
             limits["placement_mismatch"])]
