"""The port's hierarchical solve, as the tier cell builds and observes it.

`engine_kwargs` adds the hierarchy's knobs to `system.engine_kwargs`, as a
Harness with `hierarchical_solve` on passes them. `HierRecorder` keeps,
for a sample of the solves drawn from the seed (the reservoir of
`system.Recorder`), the gangs handed to the solve and each fine solve the
solve ran, in the order it ran them: through every sub-engine the engine
makes (`_make_sub_engine`), wrapped so that its exact repair is observed,
it keeps the coarse domain, the gangs in repair order, the domain's free
rows the repair was handed, the committed rows, the placements and, as a
device copy taken when the repair returns, the value tensor (K1's output
for that fine solve; the sub-engine overwrites it at its next solve). The
copies leave the card in `take_value`, after the solve's wall is read.
While it is on, it also keeps each fine solve's gangs and stats (the
shapes the kernels' rooflines count), and it holds every sub-engine, so
the graphs their LRUs evicted can be read. Nothing here changes what the
engine computes.
"""

from __future__ import annotations

import numpy as np

from .system import Record, Recorder, engine_kwargs as flat_kwargs

#: the hierarchy's knobs, by configuration key and engine keyword
HIER_KNOBS = ("hier_prune_level", "hier_min_nodes", "hier_parallel_workers")


def engine_kwargs(config: dict, device) -> dict:
    kw = flat_kwargs(config, device)
    kw.update({k: config["engine"][k] for k in HIER_KNOBS
               if k in config["engine"]})
    return kw


class Fine:
    """One fine solve of a sampled solve (`reference_hier.compare_solve`
    reads dom, names, top_val, top_dom, value and placed)."""

    __slots__ = ("engine", "dom", "order", "names", "free", "top_val",
                 "top_dom", "placed", "value", "value_dev")

    def __init__(self, engine, dom, order, top_val, top_dom, free):
        self.engine = engine
        self.dom = int(dom)
        self.order = list(order)
        self.names = [g.name for g in order]
        self.free = np.array(free, np.float32, copy=True)
        self.top_val = np.array(top_val, copy=True)
        self.top_dom = np.array(top_dom, copy=True)
        self.placed = self.value = self.value_dev = None

    def keep(self, placed) -> None:
        """After the repair: its placements, and a device copy of the
        value rows the sub-engine's cache holds for this solve."""
        self.placed = placed
        inc = getattr(self.engine, "_inc", None)
        if inc is not None and inc.value_dev is not None:
            self.value_dev = inc.value_dev[: len(self.order)].clone()


class HierRecord(Record):
    """A sampled hierarchical solve: `order` the gangs handed to it,
    `fines` its fine solves in the order they ran."""

    __slots__ = ("fines",)

    def __init__(self, engine, unit, gangs):
        super().__init__(engine, unit, None)
        self.order = list(gangs)
        self.fines: list[Fine] = []


class HierRecorder(Recorder):
    """`system.Recorder`'s reservoir over hierarchical solves; also
    `fine_runs`, (block, gangs, stats, graphs captured) of every fine
    solve while on, and `subs`, the sub-engines made."""

    def __init__(self, k: int, seed: int):
        super().__init__(k, seed)
        self.fine_runs: list = []
        self.subs: list = []

    def evictions(self) -> int:
        """Graphs the sub-engines' LRUs have evicted so far."""
        return sum(sub.debug_summary()["fused_graphs"]["evictions"]
                   for sub in self.subs)

    def begin(self, engine, gangs=()) -> None:
        unit, self.seen = self.seen, self.seen + 1
        self.current = None
        if len(self.kept) >= self.k:
            j = int(self.rng.integers(0, unit + 1))
            if j >= self.k:
                return
            self.kept.pop(j)
        self.current = HierRecord(engine, unit, gangs)
        self.kept.append(self.current)

    def fine(self, parent, dom, sub, order, top_val, top_dom, free):
        rec = self.current
        if rec is None or rec.engine is not parent:
            return None
        f = Fine(sub, dom, order, top_val, top_dom, free)
        rec.fines.append(f)
        return f

    def take_value(self) -> None:
        """Copy the sampled solve's value rows off the card (the solve
        must have been synchronised) and its placements."""
        rec, self.current = self.current, None
        if rec is None:
            return
        for f in rec.fines:
            if f.value_dev is not None:
                f.value = f.value_dev.float().cpu().numpy()
                f.value_dev = None
            f.placed = {name: np.array(p.node_indices, np.int64)
                        for name, p in (f.placed or {}).items()}

    def values_from_inputs(self) -> int:
        """For fine solves whose sub-engine kept no value tensor, the one
        its public `score_values` gives on the same gangs and free rows;
        call after the window, before the engines are released."""
        n = 0
        for rec in self.records:
            for f in rec.fines:
                if f.value is None:
                    value = f.engine.score_values(f.order, f.free)[0]
                    f.value = value[: len(f.order)].float().cpu().numpy()
                    n += 1
        return n


def engine_class(recorder: HierRecorder, base=None):
    """`base` (default the port's PlacementEngine) with a uniform sample
    of its solves, and of their fine solves, recorded by `recorder`."""
    if base is None:
        from grove_tpu_torch.solver import PlacementEngine as base

    class RecordedHier(base):
        def solve(self, gangs, *args, **kwargs):
            if recorder.on:
                recorder.begin(self, gangs)
            return super().solve(gangs, *args, **kwargs)

        def _make_sub_engine(self, shard):
            sub = super()._make_sub_engine(shard)
            repair = sub._repair
            parent, dom = self, shard.dom

            def observed(order, top_val, top_dom, free):
                f = recorder.fine(parent, dom, sub, order, top_val, top_dom,
                                  free)
                out = repair(order, top_val, top_dom, free)
                if f is not None:
                    f.keep(out[0])
                return out

            sub._repair = observed
            solve = sub.solve
            seen = [0]

            def counted(gangs, *args, **kwargs):
                res = solve(gangs, *args, **kwargs)
                # a capture in this fine solve's dispatch also ran the
                # program once eagerly before the graph's first replay
                graphs = getattr(sub, "_graphs", None)
                caps = 0 if graphs is None else graphs.captures
                if recorder.on:
                    recorder.fine_runs.append((dom, gangs, res.stats,
                                               caps - seen[0]))
                seen[0] = caps
                return res

            sub.solve = counted
            recorder.subs.append(sub)
            return sub

    return RecordedHier
