"""What the per-layer metric files (metrics/<name>.py) read a traced run
with. Each reader returns None where the run holds nothing to read."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TracedRun:
    """What a `--trace 1` run hands the metric readers.

    solves: each window solve's `result.stats` (host walls in seconds);
    kernels: {role: {"seconds", "launches"}} from the profiler;
    least: {role: (least seconds, launches counted from shapes)};
    busy_s, window_s: device busy time and the traced window's length;
    spans: the program's Tracer spans finished in the window;
    bound: gangs bound in the window."""

    solves: list = field(default_factory=list)
    kernels: dict = field(default_factory=dict)
    least: dict = field(default_factory=dict)
    busy_s: float | None = None
    window_s: float | None = None
    spans: list = field(default_factory=list)
    bound: int = 0


def mean_stat_ms(run: TracedRun, key: str) -> float | None:
    vals = [s[key] for s in run.solves if key in s]
    return 1e3 * sum(vals) / len(vals) if vals else None


def roofline_pct(run: TracedRun, role: str) -> float | None:
    """Least time from the shapes over the kernel's device time, in %.
    Nothing where the kernel did not run, or where the profiler saw
    another number of launches than the solves account for."""
    k = run.kernels.get(role)
    least = run.least.get(role)
    if not k or not least or k["seconds"] <= 0 or k["launches"] != least[1]:
        return None
    return 100.0 * least[0] / k["seconds"]


def idle_pct(run: TracedRun) -> float | None:
    if run.busy_s is None or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def self_seconds(spans, name: str) -> float:
    """Summed self time (duration less what child spans cover) of the
    spans called `name`."""
    child: dict[int, float] = {}
    for sp in spans:
        if sp.parent_id is not None:
            child[sp.parent_id] = child.get(sp.parent_id, 0.0) + (sp.t1 - sp.t0)
    return sum((sp.t1 - sp.t0) - child.get(sp.span_id, 0.0)
               for sp in spans if sp.name == name)


def reconcile_ms_per_gang(run: TracedRun) -> float | None:
    if not run.bound or not any(sp.name == "manager.reconcile"
                                for sp in run.spans):
        return None
    return 1e3 * self_seconds(run.spans, "manager.reconcile") / run.bound
