"""The plain reference of one placement solve, in NumPy.

It imports nothing of the program. From the nodes' labels, the free
capacity the benchmark keeps, and the gangs the benchmark states, it works
out again what the program's timed path computes:

- the encode: the domain index (the virtual root, then each level's
  domains in the order their label paths first appear over the nodes, the
  host level last), the domain aggregates `M^T free` and the per-signature
  fit counts;
- the device phase: the [G, D] value tensor in float32, the murmur tie
  jitter, the chunked top-k commit scan and the greedy device commit, so
  each gang's committed (value, domain);
- the exact repair: best-fit-decreasing inside the committed domain
  (preferred subdomains first, groups inside one domain of their required
  level), then the serial scan, narrowest level first, tightest domain
  first.

The arithmetic and its order follow the algorithm the program documents
(`value_plain`, `tie_jitter`, `commit_topk_plain`,
`device_commit_scan_plain`, `fit.py`, `serial.py`), copied here so the
yardstick stays fixed while the program changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .deployment import GangSpec

F32 = np.float32
NEG = F32(-1e9)
_EPS_FIT = 1e-9          # fit.py's exact-repair epsilon
_EPS_DEV = F32(1e-6)     # the device phase's aggregate epsilon


class Topology:
    """Domains of the nodes `names` (in this order), from their labels."""

    def __init__(self, labels: list[list[str]], names: list[str],
                 capacity: np.ndarray):
        self.names = list(names)
        self.capacity = np.asarray(capacity, F32)
        n = len(self.names)
        rows = [list(lv) for lv in labels] + [list(self.names)]
        self.num_levels = len(rows)
        self.domain_ids = np.zeros((self.num_levels, n), np.int32)
        counts = []
        prefixes = [()] * n
        for li, row in enumerate(rows):
            ids: dict[tuple, int] = {}
            for i, value in enumerate(row):
                prefixes[i] = prefixes[i] + (value,)
                self.domain_ids[li, i] = ids.setdefault(prefixes[i], len(ids))
            counts.append(len(ids))
        self.offsets = np.concatenate([[1], 1 + np.cumsum(counts)]).astype(
            np.int64)
        self.num_domains = int(self.offsets[-1])
        self.gdom = np.zeros((self.num_levels + 1, n), np.int64)
        self.dom_level = np.full(self.num_domains, -1, np.int32)
        for li in range(self.num_levels):
            self.gdom[li + 1] = self.domain_ids[li] + self.offsets[li]
            self.dom_level[self.offsets[li]:self.offsets[li + 1]] = li
        d = self.num_domains
        self.anc = np.full((d, self.num_levels + 1), d, np.int64)
        self.anc[0, 0] = 0
        member = np.zeros(d, np.int64)
        for li in range(self.num_levels + 1):
            member[self.gdom[li]] = np.arange(n)
        for dom in range(1, d):
            chain = self.gdom[: self.dom_level[dom] + 2, member[dom]]
            self.anc[dom, : len(chain)] = chain
        self.cap_scale = np.maximum(self.capacity.max(axis=0), 1e-9).astype(F32)

    def domain_sum(self, per_node: np.ndarray) -> np.ndarray:
        """[D, C] sums over each domain's member nodes of [N, C] rows."""
        out = np.zeros((self.num_domains, per_node.shape[1]), np.float64)
        for li in range(self.num_levels + 1):
            np.add.at(out, self.gdom[li], per_node)
        return out.astype(F32)

    def nodes_of(self, dom: int) -> tuple[np.ndarray, int]:
        level = int(self.dom_level[dom])
        if level < 0:
            return np.arange(len(self.names)), -1
        local = dom - self.offsets[level]
        return np.flatnonzero(self.domain_ids[level] == local), level


def sort_gangs(gangs: list[GangSpec]) -> list[GangSpec]:
    """Scheduling order: priority desc, fairness desc, then name."""
    return sorted(gangs, key=lambda g: (-g.priority, -g.fairness, g.name))


def _tie_jitter(g: int, d: int) -> np.ndarray:
    m32 = np.uint64(0xFFFFFFFF)
    gi = np.arange(g, dtype=np.uint64)[:, None]
    di = np.arange(d, dtype=np.uint64)[None, :]
    h = (gi * np.uint64(0x9E3779B1) + di * np.uint64(0x85EBCA77)) & m32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & m32
    h ^= h >> np.uint64(16)
    return F32(1e-4) * (h.astype(F32) / F32(2.0 ** 32))


def value_tensor(topo: Topology, free: np.ndarray,
                 gangs: list[GangSpec]) -> tuple[np.ndarray, np.ndarray]:
    """(value [G, D] f32 before the jitter, dom_free [D, R] f32)."""
    free = np.asarray(free, F32)
    dom_free = topo.domain_sum(free.astype(np.float64))
    td = np.stack([g.demand.sum(axis=0) for g in gangs]).astype(F32)
    sig_of: dict[bytes, int] = {}
    sig_rows, gang_sig = [], []
    for g in gangs:
        row = np.ascontiguousarray(g.demand.max(axis=0), F32)
        gang_sig.append(sig_of.setdefault(row.tobytes(), len(sig_rows)))
        if gang_sig[-1] == len(sig_rows):
            sig_rows.append(row)
    fits = np.stack([(free + _EPS_DEV >= row[None, :]).all(axis=1)
                     for row in sig_rows]).astype(np.float64)
    sig_cnt = topo.domain_sum(fits.T).T                     # [U, D]
    cnt_fit = sig_cnt[np.asarray(gang_sig)]
    req = np.array([g.required for g in gangs], np.int32)
    pref = np.array([g.preferred for g in gangs], np.int32)
    fair = np.array([g.fairness for g in gangs], F32)
    dl = topo.dom_level
    allowed = dl[None, :] >= req[:, None]
    level_score = F32(2.5) * (dl.astype(F32) + F32(2.0))
    bonus = (dl[None, :] >= pref[:, None]).astype(F32)
    slack = None
    for r in range(free.shape[1]):
        cur = (dom_free[:, r][None, :] - td[:, r][:, None]) / topo.cap_scale[r]
        slack = cur if slack is None else np.maximum(slack, cur)
    slack = slack / (F32(1.0) + np.abs(slack))
    value = level_score[None, :] + F32(1.0) * bonus - F32(0.5) * slack
    value = value + fair[:, None]
    return np.where((cnt_fit >= 1.0) & allowed, value, NEG).astype(F32), dom_free


def device_phase(topo: Topology, free: np.ndarray, gangs: list[GangSpec],
                 top_k: int = 8, chunk: int = 32):
    """Each sorted gang's committed (value, domain): the value tensor, the
    jitter, the chunked top-k commit scan, then the greedy device commit.
    Returns (val [G] f32, dom [G] i64, top_val [G, K], top_dom [G, K])."""
    value, dom_free = value_tensor(topo, free, gangs)
    g, d = value.shape
    jit = np.where(value > NEG / 2, value + _tie_jitter(g, d), value).astype(F32)
    td = np.stack([x.demand.sum(axis=0) for x in gangs]).astype(F32)
    r = dom_free.shape[1]
    l1 = topo.anc.shape[1]
    resid = np.concatenate([dom_free, np.zeros((1, r), F32)])
    top_val = np.empty((g, top_k), F32)
    top_dom = np.empty((g, top_k), np.int64)
    for s in range(0, g, chunk):
        tdc = td[s:s + chunk]
        fits = ((resid[:d] + _EPS_DEV)[None, :, :] >= tdc[:, None, :]).all(-1)
        rows = np.where(fits, jit[s:s + chunk], NEG)
        idx = np.argsort(-rows, axis=1, kind="stable")[:, :top_k]
        vals = np.take_along_axis(rows, idx, axis=1)
        ok = vals[:, 0] > NEG / 2
        chains = np.where(ok[:, None], topo.anc[idx[:, 0]], d)
        np.add.at(resid, chains.reshape(-1), np.repeat(-tdc, l1, axis=0))
        top_val[s:s + chunk], top_dom[s:s + chunk] = vals, idx
    resid = np.concatenate([dom_free, np.zeros((1, r), F32)])
    val = np.empty(g, F32)
    dom = np.empty(g, np.int64)
    for i in range(g):
        ok = ((resid[top_dom[i]] + _EPS_DEV >= td[i][None, :]).all(axis=1)
              & (top_val[i] > NEG / 2))
        k = int(np.argmax(ok))
        if ok.any():
            np.add.at(resid, topo.anc[top_dom[i, k]], -td[i][None, :])
            val[i] = top_val[i, k]
        else:
            val[i] = NEG
        dom[i] = top_dom[i, k]
    return val, dom, top_val, top_dom


# -- the exact repair (fit.py and serial.py's algorithm) ----------------------

@dataclass
class _Unit:
    req: int
    pref: int
    pods: np.ndarray
    children: list

    def all_pods(self) -> np.ndarray:
        return np.concatenate([self.pods] + [c.all_pods() for c in self.children])


def _units(g: GangSpec) -> _Unit:
    root = _Unit(-1, g.preferred, np.zeros(0, np.int64), [])
    direct = []
    for gi in range(len(g.group_names)):
        u = _Unit(int(g.group_required[gi]), int(g.group_preferred[gi]),
                  np.flatnonzero(g.group_ids == gi), [])
        if u.req >= 0 or u.pref >= 0:
            root.children.append(u)
        else:
            direct.append(u.pods)
    if direct:
        root.pods = np.concatenate(direct)
    return root


def _share(x: np.ndarray, cap: np.ndarray) -> np.ndarray:
    return (x / cap).max(axis=-1)


def _bfd(pods, demand, nodes, free, cap, assign) -> bool:
    if len(pods) == 0:
        return True
    for p in pods[np.argsort(-_share(demand[pods], cap), kind="stable")]:
        fits = np.all(free[nodes] + _EPS_FIT >= demand[p], axis=1)
        if not fits.any():
            return False
        cand = nodes[fits]
        n = cand[np.argmin(_share(free[cand] - demand[p], cap))]
        free[n] -= demand[p]
        assign[p] = n
    return True


def _tightest(topo, level, nodes, total, free, cap) -> list[np.ndarray]:
    ids = topo.domain_ids[level, nodes]
    keyed = []
    for did in np.unique(ids):
        d = nodes[ids == did]
        dom_free = free[d].sum(axis=0)
        if np.any(dom_free + _EPS_FIT < total):
            continue
        keyed.append((float(_share((dom_free - total)[None, :], cap)[0]),
                      len(keyed), d))
    keyed.sort(key=lambda t: (t[0], t[1]))
    return [d for _, _, d in keyed]


def _place_unit(unit, nodes, g, topo, free, cap, assign, level) -> bool:
    if unit.pref > level:
        pods = unit.all_pods()
        total = g.demand[pods].sum(axis=0)
        bare = _Unit(unit.req, -1, unit.pods, unit.children)
        for d in _tightest(topo, unit.pref, nodes, total, free, cap):
            save_f, save_a = free[d].copy(), assign[pods].copy()
            if _place_unit(bare, d, g, topo, free, cap, assign, unit.pref):
                return True
            free[d], assign[pods] = save_f, save_a
    for child in sorted(unit.children,
                        key=lambda c: -float(g.demand[c.all_pods()].sum())):
        if child.req <= level:
            ok = _place_unit(child, nodes, g, topo, free, cap, assign, level)
        else:
            ok = False
            pods = child.all_pods()
            total = g.demand[pods].sum(axis=0)
            for d in _tightest(topo, child.req, nodes, total, free, cap):
                save_f, save_a = free[d].copy(), assign[pods].copy()
                if _place_unit(child, d, g, topo, free, cap, assign, child.req):
                    ok = True
                    break
                free[d], assign[pods] = save_f, save_a
        if not ok:
            return False
    return _bfd(unit.pods, g.demand, nodes, free, cap, assign)


def place_in(g: GangSpec, topo: Topology, free: np.ndarray,
             nodes: np.ndarray, level: int):
    """Pod -> node of `g` inside `nodes` (a domain at `level`), committed
    to `free`; None (free untouched) where it does not fit."""
    if len(nodes) == 0:
        return None
    assign = np.full(g.num_pods, -1, np.int64)
    save = free[nodes].copy()
    if not _place_unit(_units(g), nodes, g, topo, free, topo.cap_scale,
                       assign, level):
        free[nodes] = save
        return None
    return assign


def place_serial(g: GangSpec, topo: Topology, free: np.ndarray):
    """The serial scan: narrowest level first, tightest domain first."""
    stop = g.required if g.required >= 0 else -1
    all_nodes = np.arange(len(topo.names))
    total = g.demand.sum(axis=0)
    for level in range(topo.num_levels - 1, stop - 1, -1):
        if level == -1:
            cands = [all_nodes]
        else:
            ids = topo.domain_ids[level]
            cands = [all_nodes[ids == d] for d in np.unique(ids)]
        keyed = []
        for d in cands:
            dom_free = free[d].sum(axis=0)
            if np.any(dom_free + _EPS_FIT < total):
                continue
            keyed.append((float(_share((dom_free - total)[None, :],
                                       topo.cap_scale)[0]), len(keyed), d))
        keyed.sort(key=lambda t: (t[0], t[1]))
        for _, _, d in keyed:
            assign = place_in(g, topo, free, d, level)
            if assign is not None:
                return assign
    return None


def repair(topo: Topology, free: np.ndarray, gangs: list[GangSpec],
           val: np.ndarray, dom: np.ndarray) -> list:
    """Each sorted gang's pod -> node array (None: unplaced), committing to
    `free` in order: the committed domain first, then the serial scan."""
    out = []
    for i, g in enumerate(gangs):
        assign = None
        if val[i] > NEG / 2:
            nodes, level = topo.nodes_of(int(dom[i]))
            assign = place_in(g, topo, free, nodes, level)
        if assign is None:
            assign = place_serial(g, topo, free)
        out.append(assign)
    return out


# -- the comparison -----------------------------------------------------------

def value_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest |program - reference| over the value entries both hold
    live (> -5e8); an entry live on one side only counts as 1e9."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return 1e9
    lp, lr = prog > NEG / 2, ref > NEG / 2
    if np.any(lp != lr):
        return 1e9
    return float(np.max(np.abs(prog[lp] - ref[lr]))) if lp.any() else 0.0


def compare_solve(topo: Topology, free: np.ndarray, gangs: list[GangSpec],
                  prog_val: np.ndarray, prog_dom: np.ndarray,
                  prog_assign: dict, prog_value: np.ndarray | None = None,
                  top_k: int = 8, chunk: int = 32,
                  prog_names: list[str] | None = None) -> dict:
    """One solve of the program against the reference's, on the same free
    state: its value tensor (`prog_value` [G, D], if given), each sorted
    gang's committed (value, domain), and its placements ({name: pod ->
    node array}). Returns value_gap (`value_gap` of the value tensors, or
    None without one), domain_mismatch (gangs whose committed domain or
    value, or whether one was committed, differs) and placement_mismatch
    (gangs placed on other nodes, or placed by one side only).
    `prog_names`: the program's sorted gang names; where they are not the
    reference's, every gang counts as mismatched."""
    gangs = sort_gangs(gangs)
    if prog_names is not None and list(prog_names) != [g.name for g in gangs]:
        return {"value_gap": 1e9, "domain_mismatch": len(gangs),
                "placement_mismatch": len(gangs), "gangs": len(gangs)}
    val, dom, _tv, _td = device_phase(topo, free, gangs, top_k, chunk)
    gap = None
    if prog_value is not None:
        gap = value_gap(prog_value, value_tensor(topo, free, gangs)[0])
    pv = np.asarray(prog_val, F32).reshape(-1)[: len(gangs)]
    pd = np.asarray(prog_dom).reshape(-1)[: len(gangs)].astype(np.int64)
    live_r, live_p = val > NEG / 2, pv > NEG / 2
    both = live_r & live_p
    dom_mis = int(np.sum((live_r != live_p)
                         | (both & ((pd != dom) | (pv != val)))))
    assigns = repair(topo, np.array(free, F32, copy=True), gangs, val, dom)
    place_mis = 0
    for g, a in zip(gangs, assigns):
        p = prog_assign.get(g.name)
        if (a is None) != (p is None) or (
                a is not None and not np.array_equal(np.asarray(p), a)):
            place_mis += 1
    return {"value_gap": gap, "domain_mismatch": dom_mis,
            "placement_mismatch": place_mis, "gangs": len(gangs)}


def guarantee_violations(topo: Topology, free: np.ndarray,
                         gangs: list[GangSpec], placements: dict) -> int:
    """Placements ({name: pod -> node array}) of one solve, committed in
    order to `free` (mutated): count of gangs placed in part, on a node
    whose free capacity does not hold a pod, or outside one domain of a
    required level (the gang's, or a group's)."""
    bad = 0
    for g in sort_gangs(gangs):
        a = placements.get(g.name)
        if a is None:
            continue
        a = np.asarray(a, np.int64)
        ok = len(a) == g.num_pods and bool(np.all(a >= 0))
        if ok:
            np.subtract.at(free, a, g.demand)
            ok = bool(np.all(free[np.unique(a)] >= -1e-6))
        if ok and g.required >= 0:
            ok = len(np.unique(topo.domain_ids[g.required, a])) == 1
        for gi in range(len(g.group_names)):
            lv = int(g.group_required[gi])
            if ok and lv >= 0:
                ok = len(np.unique(topo.domain_ids[lv, a[g.group_ids == gi]])) == 1
        bad += not ok
    return bad

