"""The serial baseline scorer.

The counterpart of grove_tpu/solver/serial.py: one gang at a time, one
candidate domain at a time, exact feasibility per try. The engine's
repair falls back to `_place_one` (the exactness net) for any gang whose
device candidates all fail, so hard-feasibility semantics stay identical
to the serial path.

Search order per gang: levels narrowest -> broadest down to the gang's
required level (so the first success is also the best achievable
single-domain packing = max placement score), domains within a level
tightest-fit first.
"""

from __future__ import annotations

import time

import numpy as np

from ..observability.explain import diagnose_unplaced
from ..topology.encoding import TopologySnapshot
from .fit import (
    _order_domains_tightest,
    place_gang_in_domain,
    placement_score_for_nodes,
)
from .problem import SolverGang
from .result import GangPlacement, SolveResult


def gang_sort_key(g: SolverGang):
    """Deterministic scheduling order: priority desc, tenant fairness
    weight desc, then name."""
    return (-g.priority, -getattr(g, "fairness", 0.0), g.name)


def stamp_fairness(gangs: list[SolverGang], fairness) -> None:
    """Apply a fairness-weight vector onto the gangs. Keys are
    namespace-qualified "namespace/name", with bare gang names accepted
    as a fallback. Missing gangs keep their current stamp."""
    if not fairness:
        return
    for g in gangs:
        w = fairness.get(f"{g.namespace}/{g.name}")
        if w is None:
            w = fairness.get(g.name)
        if w is not None:
            g.fairness = float(w)


def solve_serial(
    snapshot: TopologySnapshot,
    gangs: list[SolverGang],
    free: np.ndarray | None = None,
    fairness: dict[str, float] | None = None,
) -> SolveResult:
    """Place gangs serially against (a copy of) the snapshot's free capacity.

    Passing `free` lets callers thread committed state across calls; it is
    mutated in place as gangs commit.
    """
    t0 = time.perf_counter()
    stamp_fairness(gangs, fairness)
    if free is None:
        free = snapshot.free.copy()
    sched_nodes = np.flatnonzero(snapshot.schedulable)
    result = SolveResult()
    for gang in sorted(gangs, key=gang_sort_key):
        if gang.unschedulable_reason:
            result.unplaced[gang.name] = gang.unschedulable_reason
            continue
        placed = _place_one(gang, snapshot, free, sched_nodes)
        if placed is None:
            result.unplaced[gang.name] = diagnose_unplaced(
                gang, snapshot, free
            )
        else:
            result.placed[gang.name] = placed
    result.wall_seconds = time.perf_counter() - t0
    return result


def _place_one(
    gang: SolverGang,
    snapshot: TopologySnapshot,
    free: np.ndarray,
    sched_nodes: np.ndarray,
) -> GangPlacement | None:
    stop_level = gang.required_level if gang.required_level >= 0 else -1
    # Narrowest level first: the first domain that fits yields the highest
    # placement score achievable for a single-domain packing. Level -1 is
    # the virtual cluster root (only reached when unconstrained).
    for level in range(snapshot.num_levels - 1, stop_level - 1, -1):
        if level == -1:
            candidates = [sched_nodes]
        else:
            ids = snapshot.domain_ids[level, sched_nodes]
            candidates = [sched_nodes[ids == d] for d in np.unique(ids)]
        cap_scale = np.maximum(snapshot.capacity.max(axis=0), 1e-9)
        candidates = _order_domains_tightest(
            candidates, gang.total_demand(), free, cap_scale
        )
        for dom in candidates:
            assign = place_gang_in_domain(gang, snapshot, free, dom, level)
            if assign is not None:
                return GangPlacement(
                    gang=gang,
                    pod_to_node={
                        gang.pod_names[i]: snapshot.node_names[assign[i]]
                        for i in range(gang.num_pods)
                    },
                    node_indices=assign,
                    placement_score=placement_score_for_nodes(snapshot, assign),
                )
    return None
