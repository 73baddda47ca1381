"""Exact placement primitives: best-fit-decreasing under pack constraints.

The counterpart of grove_tpu/solver/fit.py, unchanged in behaviour: these
are the *hard feasibility* semantics of the framework. Both solve paths
call into here -- the serial baseline uses them as its inner loop, the
engine uses them as the repair/commit phase after approximate scoring on
the device.

Constraint model (matches the PodGang contract, podgang.go:51-132):
  gang level      -- all gang pods inside one domain at required_level
  constraint group-- a subset of PodGroups inside one domain at its level
                    (PCSG co-location inside a base gang)
  pod group       -- one PodGroup's pods inside one domain at its level
preferred levels are soft: placement is first attempted inside a single
domain at the preferred level and falls back to the enclosing domain.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..topology.encoding import TopologySnapshot
from .problem import SolverGang

_EPS = 1e-9


@dataclass
class _Unit:
    """A co-location unit: pods that must land in one domain at req_level."""

    req_level: int = -1
    pref_level: int = -1
    pods: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    children: list["_Unit"] = field(default_factory=list)

    def all_pods(self) -> np.ndarray:
        parts = [self.pods] + [c.all_pods() for c in self.children]
        return np.concatenate(parts) if parts else self.pods


def _build_unit_tree(gang: SolverGang) -> _Unit:
    """gang -> constraint-group -> pod-group unit hierarchy."""
    num_groups = len(gang.group_names)
    in_cg = set()
    root = _Unit(req_level=gang.required_level, pref_level=gang.preferred_level)
    for members, req, pref in gang.constraint_groups:
        cg = _Unit(req_level=req, pref_level=pref)
        for gi in members:
            in_cg.add(gi)
            cg.children.append(_group_unit(gang, gi))
        root.children.append(cg)
    direct_pods = []
    for gi in range(num_groups):
        if gi in in_cg:
            continue
        u = _group_unit(gang, gi)
        if u.req_level >= 0 or u.pref_level >= 0:
            root.children.append(u)
        else:
            direct_pods.append(u.pods)
    root.pods = (
        np.concatenate(direct_pods) if direct_pods else np.zeros(0, dtype=np.int64)
    )
    return root


def _group_unit(gang: SolverGang, gi: int) -> _Unit:
    return _Unit(
        req_level=int(gang.group_required_level[gi]),
        pref_level=int(gang.group_preferred_level[gi]),
        pods=np.flatnonzero(gang.group_ids == gi),
    )


def _dominant_share(demand: np.ndarray, cap_scale: np.ndarray) -> np.ndarray:
    """Dominant resource share of each demand row, for BFD ordering."""
    return (demand / cap_scale).max(axis=-1)


def _best_fit_decreasing(
    pod_idx: np.ndarray,
    demand: np.ndarray,
    node_idx: np.ndarray,
    free: np.ndarray,
    cap_scale: np.ndarray,
    assign: np.ndarray,
    pod_elig: Optional[list] = None,
) -> bool:
    """Place pods (largest-first) on the tightest node that fits; mutates
    free and assign in place. Returns False (partial mutation possible --
    callers restore the affected rows) when any pod doesn't fit.

    pod_elig: SolverGang.pod_elig -- per-pod bool [N] node-eligibility
    masks (node_selector/tolerations); None entries are unconstrained."""
    if len(pod_idx) == 0:
        return True
    order = np.argsort(-_dominant_share(demand[pod_idx], cap_scale), kind="stable")
    for p in pod_idx[order]:
        fits = np.all(free[node_idx] + _EPS >= demand[p], axis=1)
        if pod_elig is not None and pod_elig[p] is not None:
            fits &= pod_elig[p][node_idx]
        if not fits.any():
            return False
        cand = node_idx[fits]
        leftover = _dominant_share(free[cand] - demand[p], cap_scale)
        n = cand[np.argmin(leftover)]  # tightest fit; argmin ties -> lowest idx
        free[n] -= demand[p]
        assign[p] = n
    return True


def _subdomains_within(
    snapshot: TopologySnapshot, level: int, node_idx: np.ndarray
) -> list[np.ndarray]:
    """Split node_idx by domain membership at `level`, tightest-total-free
    first ordering is applied by the caller."""
    ids = snapshot.domain_ids[level, node_idx]
    out = []
    for did in np.unique(ids):
        out.append(node_idx[ids == did])
    return out


def _order_domains_tightest(
    doms: list[np.ndarray], total_demand: np.ndarray, free: np.ndarray,
    cap_scale: np.ndarray,
) -> list[np.ndarray]:
    """Best-fit at domain granularity: among domains whose aggregate free
    covers the demand, tightest first; clearly-infeasible domains dropped."""
    keyed = []
    for d in doms:
        dom_free = free[d].sum(axis=0)
        if np.any(dom_free + _EPS < total_demand):
            continue
        keyed.append((float(_dominant_share((dom_free - total_demand)[None, :], cap_scale)[0]), len(keyed), d))
    keyed.sort(key=lambda t: (t[0], t[1]))
    return [d for _, _, d in keyed]


def _place_unit(
    unit: _Unit,
    node_idx: np.ndarray,
    gang: SolverGang,
    snapshot: TopologySnapshot,
    free: np.ndarray,
    cap_scale: np.ndarray,
    assign: np.ndarray,
    domain_level: int,
) -> bool:
    """Place a unit's children + direct pods within node_idx. Mutates
    free/assign in place; on failure the caller restores the node_idx rows
    of free and this unit's assign entries (row-scoped backtracking)."""
    # Soft preference: first try the whole unit inside one preferred-level
    # subdomain (only meaningful when pref is narrower than where we are).
    if unit.pref_level > domain_level:
        pods_all = unit.all_pods()
        total = gang.demand[pods_all].sum(axis=0)
        doms = _subdomains_within(snapshot, unit.pref_level, node_idx)
        stripped = _Unit(req_level=unit.req_level, pref_level=-1,
                         pods=unit.pods, children=unit.children)
        for d in _order_domains_tightest(doms, total, free, cap_scale):
            # Row-scoped backtracking: a failed try can only have mutated
            # free rows inside d and assign entries of this unit's pods.
            save_free, save_assign = free[d].copy(), assign[pods_all].copy()
            if _place_unit(stripped, d, gang, snapshot, free, cap_scale,
                           assign, unit.pref_level):
                return True
            free[d], assign[pods_all] = save_free, save_assign
        # fall through: preference unsatisfiable, place unrestricted
    # Children first, largest demand first (harder to place).
    children = sorted(
        unit.children,
        key=lambda c: -float(gang.demand[c.all_pods()].sum()),
    )
    for child in children:
        if not _place_child(child, node_idx, gang, snapshot, free, cap_scale,
                            assign, domain_level):
            return False
    return _best_fit_decreasing(
        unit.pods, gang.demand, node_idx, free, cap_scale, assign,
        gang.pod_elig,
    )


def _place_child(
    child: _Unit,
    node_idx: np.ndarray,
    gang: SolverGang,
    snapshot: TopologySnapshot,
    free: np.ndarray,
    cap_scale: np.ndarray,
    assign: np.ndarray,
    domain_level: int,
) -> bool:
    """Place a constrained child inside exactly one subdomain at its
    required level (trying candidates tightest-first with backtracking)."""
    if child.req_level <= domain_level:
        # Constraint already satisfied by the enclosing domain (or absent) --
        # place within the parent domain, honoring any preference.
        return _place_unit(child, node_idx, gang, snapshot, free, cap_scale,
                           assign, domain_level)
    pods_all = child.all_pods()
    total = gang.demand[pods_all].sum(axis=0)
    doms = _subdomains_within(snapshot, child.req_level, node_idx)
    for d in _order_domains_tightest(doms, total, free, cap_scale):
        save_free, save_assign = free[d].copy(), assign[pods_all].copy()
        if _place_unit(child, d, gang, snapshot, free, cap_scale, assign,
                       child.req_level):
            return True
        free[d], assign[pods_all] = save_free, save_assign
    return False


def place_gang_in_domain(
    gang: SolverGang,
    snapshot: TopologySnapshot,
    free: np.ndarray,
    node_idx: np.ndarray,
    domain_level: int = -1,
) -> Optional[np.ndarray]:
    """Try to place all gang pods onto nodes in node_idx.

    free is the CURRENT global free matrix [N, R]; it is mutated only on
    success. Returns pod->global-node-index array, or None if infeasible.
    """
    if len(node_idx) == 0:
        return None
    cap_scale = np.maximum(snapshot.capacity.max(axis=0), _EPS)
    assign = np.full(gang.num_pods, -1, dtype=np.int64)
    save_free = free[node_idx].copy()  # only these rows can be mutated
    root = _build_unit_tree(gang)
    root.req_level = -1  # domain already chosen by the caller
    if not _place_unit(root, node_idx, gang, snapshot, free, cap_scale,
                       assign, domain_level):
        free[node_idx] = save_free
        return None
    return assign


def placement_score_for_nodes(
    snapshot: TopologySnapshot, node_indices: np.ndarray
) -> float:
    """Network-optimality score in (0, 1] (podgang.go:177-179): 1.0 when all
    pods share the narrowest (host) domain, decreasing as the gang spans
    broader levels; floor when the gang only shares the cluster root."""
    levels = snapshot.num_levels
    if len(node_indices) == 0:
        return 1.0
    narrowest = -1  # -1 = only the virtual cluster root contains the gang
    for level in range(levels - 1, -1, -1):
        ids = snapshot.domain_ids[level, node_indices]
        if (ids == ids[0]).all():
            narrowest = level
            break
    return (narrowest + 2) / (levels + 1)
