"""The plain reference of the two-level (hierarchical) solve, in NumPy.

It imports nothing of the program. For one backlog and one free state it
works out again what the program's hierarchical path computes (the
algorithm `solver/hierarchy.py` and `engine._hier_run` document):

1. the prune level: the broadest level every gang requires, walked
   broader while it has more than 4096 domains (none below two: flat);
2. the coarse pass over the prune level's domains: each domain's free
   capacity summed in float64 in node order, its largest free on one node
   a resource, and three cuts a gang -- no schedulable node, aggregate
   free short of the gang's total demand, no node holding its largest
   pod (a gang's one signature);
3. the chunked best-fit commit over residual aggregates: 256 gangs a
   chunk, each gang's up to four tightest feasible domains by slack (an
   argpartition, then a stable sort inside it: the program's tie rule),
   the last of them swapped for the loosest feasible domain where that
   is not among them, every chunk's first choices committed before the
   next chunk ranks;
4. the fine solves, in waves by attempt: each domain's gangs solved on
   the domain's sub-topology (the levels at and above the prune level
   dropped, the gangs' levels shifted below it) by `reference.py`'s
   device phase and exact repair, committed in domain order; a gang that
   fails walks its alternates, then up to two more rounds re-aggregate
   over the live free with the domains it tried masked out;
5. the serial net: each gang still unplaced takes the serial scan over
   the nodes of the domains it was first admissible in, then over the
   whole cluster.

Departures, each a simplification the benchmark's deployments allow:
every node is schedulable (no cordon, so the first cut never fires), and
no gang carries eligibility masks, so a gang's one signature is its
largest pod and no constraint group needs dropping when levels shift.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from . import reference
from .deployment import GangSpec

#: the coarse pass's ceiling on the prune level's domain count
MAX_COARSE_DOMAINS = 4096
#: coarse commit: gangs a chunk, ranked alternates a gang, the epsilon
COARSE_CHUNK = 256
COARSE_TOP = 4
_EPS = 1e-6
#: fine solve rounds: the first, then two that re-aggregate
ROUNDS = 3


class Hierarchy:
    """The whole cluster's `reference.Topology` and, built as asked, each
    prune-level domain's node rows and sub-topology."""

    def __init__(self, labels, names, capacity):
        self.labels = [list(lv) for lv in labels]
        self.names = list(names)
        self.capacity = np.asarray(capacity, np.float32)
        self.topo = reference.Topology(self.labels, self.names, self.capacity)
        self._subs: dict[tuple[int, int], tuple] = {}

    def domain(self, level: int, dom: int):
        """(node rows in node order, sub-topology) of domain `dom` of
        `level`: the levels below it, re-indexed from its first node."""
        key = (level, dom)
        if key not in self._subs:
            rows = np.flatnonzero(self.topo.domain_ids[level] == dom)
            sub = reference.Topology(
                [[self.labels[lv][i] for i in rows]
                 for lv in range(level + 1, len(self.labels))],
                [self.names[i] for i in rows], self.capacity[rows])
            self._subs[key] = (rows, sub)
        return self._subs[key]


def prune_level(topo: reference.Topology, gangs: list[GangSpec],
                min_nodes: int = 0):
    """The level the backlog is solved at hierarchically, or None (flat:
    no gang, a cluster under `min_nodes`, a gang required nowhere, or
    fewer than two domains)."""
    if not gangs or len(topo.names) < min_nodes:
        return None
    level = min(g.required for g in gangs)
    if level < 0:
        return None
    counts = np.diff(topo.offsets)
    while level > 0 and counts[level] > MAX_COARSE_DOMAINS:
        level -= 1
    return level if counts[level] >= 2 else None


def shift(level: int, prune: int) -> int:
    """A level of the whole topology as its index below the prune level;
    -1 at or above it (the sub-topology's root is the domain itself)."""
    if level < 0:
        return level
    return level - prune - 1 if level > prune else -1


def sub_spec(g: GangSpec, prune: int) -> GangSpec:
    """The gang as a fine solve states it, its levels shifted."""
    return replace(
        g, required=shift(g.required, prune),
        preferred=shift(g.preferred, prune),
        group_required=np.array([shift(int(v), prune)
                                 for v in g.group_required], np.int32),
        group_preferred=np.array([shift(int(v), prune)
                                  for v in g.group_preferred], np.int32))


def coarse_admissible(topo: reference.Topology, free: np.ndarray,
                      gangs: list[GangSpec], level: int):
    """(admissible [G, nd] bool, dom_free [nd, R] float64)."""
    ids = topo.domain_ids[level]
    nd = int(topo.offsets[level + 1] - topo.offsets[level])
    free = np.asarray(free, np.float32)
    dom_free = np.empty((nd, free.shape[1]), np.float64)
    for r in range(free.shape[1]):
        dom_free[:, r] = np.bincount(ids, weights=free[:, r], minlength=nd)
    max_free = np.zeros_like(dom_free)
    np.maximum.at(max_free, ids, free.astype(np.float64))
    schedulable = np.bincount(ids, minlength=nd) > 0
    td = np.stack([g.demand.sum(axis=0) for g in gangs]).astype(np.float64)
    big = np.stack([g.demand.max(axis=0) for g in gangs]).astype(np.float64)
    capacity_ok = (dom_free[None] + _EPS >= td[:, None]).all(axis=-1)
    fit_ok = (max_free[None] + _EPS >= big[:, None]).all(axis=-1)
    return schedulable[None] & capacity_ok & fit_ok, dom_free


def coarse_assign(gangs: list[GangSpec], admissible: np.ndarray,
                  dom_free: np.ndarray, cap_scale: np.ndarray,
                  top: int) -> list[list[int]]:
    """Each gang's ranked coarse domains ([] where none is feasible)."""
    resid = dom_free.astype(np.float64).copy()
    scale = np.maximum(np.asarray(cap_scale, np.float64), _EPS)
    td = np.stack([g.demand.sum(axis=0) for g in gangs]).astype(np.float64)
    nd = resid.shape[0]
    out: list[list[int]] = []
    for start in range(0, len(gangs), COARSE_CHUNK):
        end = min(start + COARSE_CHUNK, len(gangs))
        first = []
        for i in range(start, end):
            leftover = (resid - td[i][None, :]) / scale
            feas = admissible[i] & (leftover >= -_EPS / scale).all(axis=-1)
            slack = np.where(feas, leftover.max(axis=-1), np.inf)
            nf = int(feas.sum())
            part = np.argpartition(slack, min(top, nd - 1))[:top]
            alts = part[np.argsort(slack[part], kind="stable")][
                :min(top, nf)].tolist()
            if nf > len(alts):
                loosest = int(np.where(feas, slack, -np.inf).argmax())
                if loosest not in alts:
                    alts[-1] = loosest
            out.append(alts)
            first.append(alts[0] if alts else -1)
        for i, dom in zip(range(start, end), first):
            if dom >= 0:
                resid[dom] -= td[i]
    return out


@dataclass
class Fine:
    """One fine solve: the coarse domain, its gangs in repair order
    (names), the domain's free rows as handed over, the committed value
    and sub-topology domain a gang, the value tensor [G, D] and each
    gang's local node rows (None: not placed here)."""

    dom: int
    names: list[str]
    free: np.ndarray
    val: np.ndarray
    committed: np.ndarray
    value: np.ndarray
    assigns: list


@dataclass
class Solve:
    """The reference's whole two-level solve of one backlog."""

    level: int | None
    choices: list = field(default_factory=list)   # round 0, by sorted gang
    fines: list = field(default_factory=list)
    placed: dict = field(default_factory=dict)    # name -> global nodes
    net: list = field(default_factory=list)       # names the net took


def fine_solve(hier: Hierarchy, level: int, dom: int, free: np.ndarray,
               gangs: list[GangSpec], top_k: int, chunk: int) -> Fine:
    """Solve `gangs` (sorted) inside one domain and commit to `free`."""
    rows, sub = hier.domain(level, dom)
    specs = [sub_spec(g, level) for g in gangs]
    local = free[rows]
    before = local.copy()
    val, committed, _tv, _td = reference.device_phase(sub, local, specs,
                                                      top_k, chunk)
    value = reference.value_tensor(sub, before, specs)[0]
    assigns = reference.repair(sub, local, specs, val, committed)
    free[rows] = local
    return Fine(dom, [g.name for g in gangs], before, val, committed, value,
                assigns)


def place_serial_in(g: GangSpec, topo: reference.Topology, free: np.ndarray,
                    nodes: np.ndarray):
    """`reference.place_serial` over `nodes` alone."""
    stop = g.required if g.required >= 0 else -1
    total = g.demand.sum(axis=0)
    for lv in range(topo.num_levels - 1, stop - 1, -1):
        if lv == -1:
            cands = [nodes]
        else:
            ids = topo.domain_ids[lv, nodes]
            cands = [nodes[ids == d] for d in np.unique(ids)]
        keyed = []
        for d in cands:
            dom_free = free[d].sum(axis=0)
            if np.any(dom_free + reference._EPS_FIT < total):
                continue
            keyed.append((float(reference._share((dom_free - total)[None, :],
                                                 topo.cap_scale)[0]),
                          len(keyed), d))
        keyed.sort(key=lambda t: (t[0], t[1]))
        for _, _, d in keyed:
            assign = reference.place_in(g, topo, free, d, lv)
            if assign is not None:
                return assign
    return None


def solve(hier: Hierarchy, free: np.ndarray, gangs: list[GangSpec],
          top_k: int = 8, chunk: int = 32, min_nodes: int = 0) -> Solve:
    """The two-level solve of `gangs` against `free` (mutated as gangs
    commit). A backlog the program would solve flat gives level None and
    nothing else."""
    topo = hier.topo
    order = reference.sort_gangs(gangs)
    level = prune_level(topo, order, min_nodes)
    out = Solve(level)
    if level is None:
        return out
    nd = int(topo.offsets[level + 1] - topo.offsets[level])
    top = min(COARSE_TOP, nd)
    admissible, dom_free = coarse_admissible(topo, free, order, level)
    out.choices = coarse_assign(order, admissible, dom_free, topo.cap_scale,
                                top)
    pending = list(range(len(order)))
    tried: dict[int, set] = {i: set() for i in pending}
    choices = dict(enumerate(out.choices))
    for rnd in range(ROUNDS):
        if not pending:
            break
        if rnd > 0:
            sub = [order[i] for i in pending]
            adm, dfree = coarse_admissible(topo, free, sub, level)
            for row, i in enumerate(pending):
                adm[row, sorted(tried[i])] = False
            ranked = coarse_assign(sub, adm, dfree, topo.cap_scale, top)
            choices = dict(zip(pending, ranked))
        attempt = 0
        while pending:
            groups: dict[int, list] = {}
            leftover = []
            for i in pending:
                alts = choices.get(i) or []
                if attempt < len(alts):
                    groups.setdefault(alts[attempt], []).append(i)
                else:
                    leftover.append(i)
            if not groups:
                pending = leftover
                break
            failed = []
            for dom in sorted(groups):
                members = groups[dom]
                fine = fine_solve(hier, level, dom, free,
                                  [order[i] for i in members], top_k, chunk)
                rows = hier.domain(level, dom)[0]
                for i, a in zip(members, fine.assigns):
                    tried[i].add(dom)
                    if a is None:
                        failed.append(i)
                    else:
                        out.placed[order[i].name] = rows[a]
                out.fines.append(fine)
            pending = sorted(leftover + failed)
            attempt += 1
    everywhere = np.arange(len(topo.names))
    for i in pending:
        g = order[i]
        nodes = everywhere
        if admissible[i].any():
            nodes = everywhere[admissible[i][topo.domain_ids[level]]]
        a = place_serial_in(g, topo, free, nodes)
        if a is None and nodes is not everywhere:
            a = place_serial_in(g, topo, free, everywhere)
        out.net.append(g.name)
        if a is not None:
            out.placed[g.name] = a
    return out


def compare_solve(hier: Hierarchy, free: np.ndarray, gangs: list[GangSpec],
                  prog_fines: list, prog_placed: dict, top_k: int = 8,
                  chunk: int = 32, min_nodes: int = 0) -> dict:
    """One hierarchical solve of the program against the reference's, on
    the same free state (not mutated). `prog_fines`: the program's fine
    solves in the order it ran them, each with `dom`, `names` (repair
    order), `top_val` / `top_dom` (the committed rows), `value` ([G, D]
    or None) and `placed` ({name: local node rows}); `prog_placed`: every
    gang's final global node rows ({name: rows}, placed gangs only).

    Returns coarse_mismatch (gangs whose first fine domain is not the
    reference's first coarse choice), value_gap (the largest over the fine
    solves of `reference.value_gap`), domain_mismatch and
    placement_mismatch (as `reference.compare_solve` counts them, summed
    over the fine solves paired in order; a pair with another domain or
    other gangs, and a fine solve one side ran alone, counts every gang
    it holds), and the placements of the gangs the net took."""
    ref = solve(hier, np.array(free, np.float32, copy=True), gangs, top_k,
                chunk, min_nodes)
    order = reference.sort_gangs(gangs)
    if ref.level is None:
        n = len(order)
        return {"coarse_mismatch": n, "value_gap": 1e9, "domain_mismatch": n,
                "placement_mismatch": n, "gangs": n, "fine_solves": 0}
    first: dict[str, int] = {}
    for f in prog_fines:
        for name in f.names:
            first.setdefault(name, int(f.dom))
    coarse = sum(first.get(g.name, -1) != (c[0] if c else -1)
                 for g, c in zip(order, ref.choices))
    gap, dom_mis, place_mis = 0.0, 0, 0
    for k in range(max(len(ref.fines), len(prog_fines))):
        r = ref.fines[k] if k < len(ref.fines) else None
        p = prog_fines[k] if k < len(prog_fines) else None
        if r is None or p is None or int(p.dom) != r.dom \
                or list(p.names) != r.names:
            n = len(r.names if r is not None else p.names)
            gap, dom_mis, place_mis = 1e9, dom_mis + n, place_mis + n
            continue
        if p.value is not None:
            gap = max(gap, reference.value_gap(p.value, r.value))
        n = len(r.names)
        pv = np.asarray(p.top_val, np.float32).reshape(-1)[:n]
        pd = np.asarray(p.top_dom).reshape(-1)[:n].astype(np.int64)
        live_r, live_p = r.val > reference.NEG / 2, pv > reference.NEG / 2
        both = live_r & live_p
        dom_mis += int(np.sum((live_r != live_p)
                              | (both & ((pd != r.committed) | (pv != r.val)))))
        for name, a in zip(r.names, r.assigns):
            q = p.placed.get(name)
            if (a is None) != (q is None) or (
                    a is not None and not np.array_equal(np.asarray(q), a)):
                place_mis += 1
    for name in ref.net:
        a, q = ref.placed.get(name), prog_placed.get(name)
        if (a is None) != (q is None) or (
                a is not None and not np.array_equal(np.asarray(q), a)):
            place_mis += 1
    return {"coarse_mismatch": int(coarse), "value_gap": gap,
            "domain_mismatch": dom_mis, "placement_mismatch": place_mis,
            "gangs": len(order), "fine_solves": len(ref.fines),
            "net": len(ref.net)}
