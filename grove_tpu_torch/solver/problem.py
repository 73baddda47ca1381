"""Solver-side problem encoding: the dense gang struct.

The counterpart of grove_tpu/solver/problem.py, trimmed to `SolverGang`
and the per-pod mask encoding the native repair ships
(`dedupe_pod_masks`). Encoding PodGang objects into SolverGangs
(`encode_podgangs`) arrives with the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SolverGang:
    """One gang, dense. P pods, R resources (R matches the snapshot)."""

    name: str
    namespace: str
    demand: np.ndarray                 # float32 [P, R]
    pod_names: list[str]               # len P (pod metadata names)
    group_ids: np.ndarray              # int32 [P] -- index into groups
    group_names: list[str]
    # Per-group pack levels, resolved to snapshot level indices; -1 = none.
    group_required_level: np.ndarray   # int32 [num_groups]
    group_preferred_level: np.ndarray  # int32 [num_groups]
    # Gang-level pack constraint (PodGangSpec.TopologyConstraint).
    required_level: int = -1
    preferred_level: int = -1
    priority: float = 0.0
    # Tenant fairness weight: orders gangs of EQUAL priority in the commit
    # order (gang_sort_key) and rides the value tensor as a per-row offset.
    fairness: float = 0.0
    # Constraint groups spanning subsets of groups (PCSG co-location inside a
    # base gang, podgang.go:121-132): (member group indices, required_level,
    # preferred_level).
    constraint_groups: list[tuple[list[int], int, int]] = field(default_factory=list)
    # Set when the gang cannot legally be solved at all; the solve reports
    # it unplaced with this reason instead of scheduling it unconstrained.
    unschedulable_reason: Optional[str] = None
    # Per-pod node-eligibility masks (node_selector + taint tolerations):
    # None = every pod unconstrained; else len-P list whose entries are
    # shared read-only bool [N] arrays (or None for an individually
    # unconstrained pod). Hard filter -- enforced exactly by fit.py and
    # priced into the device score.
    pod_elig: Optional[list] = None

    @property
    def num_pods(self) -> int:
        return int(self.demand.shape[0])

    def total_demand(self) -> np.ndarray:
        # cached: demand is frozen after construction
        td = getattr(self, "_total_demand", None)
        if td is None:
            td = self.demand.sum(axis=0)
            object.__setattr__(self, "_total_demand", td)
        return td

    def max_pod_demand(self) -> np.ndarray:
        return self.demand.max(axis=0) if self.num_pods else self.demand.sum(axis=0)

    def sig_max_demand(self) -> np.ndarray:
        """Elementwise max over the signature demands: the fit upper bound
        the hierarchical pruner compares against each domain's max node
        free (a domain where some resource cannot satisfy this on any node
        fits no signature). Cached like total_demand."""
        m = getattr(self, "_sig_max", None)
        if m is None:
            m = np.max([dem for dem, _mask in self.elig_signatures()], axis=0)
            object.__setattr__(self, "_sig_max", m)
        return m

    def elig_signatures(self) -> list:
        """(max-pod demand, eligibility mask) pairs, one per distinct mask
        class in the gang -- the node-granularity fit proxy the
        unsat-diagnosis funnel shares with the device score. Cached."""
        sigs = getattr(self, "_elig_sigs", None)
        if sigs is not None:
            return sigs
        if self.pod_elig is None:
            sigs = [(self.max_pod_demand(), None)]
        else:
            by_mask: dict[int, tuple] = {}
            for p in range(self.num_pods):
                mask = self.pod_elig[p]
                key = 0 if mask is None else id(mask)
                cur = by_mask.get(key)
                dem = self.demand[p]
                by_mask[key] = (
                    dem if cur is None else np.maximum(cur[0], dem),
                    mask,
                )
            sigs = list(by_mask.values())
        object.__setattr__(self, "_elig_sigs", sigs)
        return sigs


def dedupe_pod_masks(
    gangs: list[SolverGang],
) -> tuple[list[np.ndarray], np.ndarray]:
    """Flatten per-pod eligibility masks across a gang list into unique
    rows + a per-pod row index (-1 = unconstrained). Masks are shared
    read-only arrays (snapshot.eligibility cache), so identity dedup keeps
    the row count tiny."""
    total = sum(g.num_pods for g in gangs)
    idx = np.full(total, -1, np.int32)
    rows: list[np.ndarray] = []
    row_of: dict[int, int] = {}
    p = 0
    for g in gangs:
        for j in range(g.num_pods):
            mask = g.pod_elig[j] if g.pod_elig is not None else None
            if mask is not None:
                row = row_of.get(id(mask))
                if row is None:
                    row = len(rows)
                    row_of[id(mask)] = row
                    rows.append(mask)
                idx[p] = row
            p += 1
    return rows, idx
