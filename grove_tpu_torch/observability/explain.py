"""Structured unsat diagnosis for unplaced gangs.

The counterpart of grove_tpu/observability/explain.py, trimmed to what a
solve emits: the shared reason-code vocabulary (`UnsatCode`), the
`UnsatDiagnosis` str subclass carrying `.code` and `.funnel`, and
`diagnose_unplaced`, the candidate-domain elimination FUNNEL: every
topology domain (plus the virtual cluster root) is attributed to exactly
one cut -- topology hierarchy, cordon/NotReady exclusion, capacity
(aggregate or node-shape, with the binding resource and its shortfall),
eligibility masks -- or survives as statically feasible.

Everything here runs on host numpy from state the solve already
materialized, and only for unplaced gangs.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np

_EPS = 1e-6


class UnsatCode(str, Enum):
    """Machine-readable unplaced-gang reason codes (values identical to
    grove_tpu's, so the two packages' results compare by value)."""

    #: a required pack level's label key is absent from the topology
    UNRESOLVED_LEVEL = "UnresolvedTopologyLevel"
    #: no candidate domain has the capacity
    CAPACITY = "InsufficientCapacity"
    #: capacity exists, but node selectors / untolerated taints exclude
    #: every node that would fit
    ELIGIBILITY = "EligibilityExcluded"
    #: every candidate domain lost all its schedulable nodes
    CORDONED = "NodesUnavailable"
    #: the topology hierarchy itself cut every domain
    TOPOLOGY = "TopologyConstrained"
    #: statically-feasible domains existed but exact placement failed in
    #: all of them
    CONFLICT = "PlacementConflict"
    #: tenant admission shed the gang
    QUOTA = "QuotaExceeded"
    #: the legacy magic string from a custom/older engine
    NO_FEASIBLE_DOMAIN = "NoFeasibleDomain"
    #: the federation router cut every member cluster
    NO_FEASIBLE_CLUSTER = "NoFeasibleCluster"
    #: the streaming admission front shed the gang
    DEADLINE = "DeadlineExceeded"


class UnsatDiagnosis(str):
    """An unplaced-gang reason: a human-readable message that IS a str,
    carrying the structured `.code` and the elimination `.funnel`."""

    code: UnsatCode
    funnel: Optional[dict]

    def __new__(cls, message: str, code: UnsatCode = UnsatCode.NO_FEASIBLE_DOMAIN,
                funnel: Optional[dict] = None):
        self = super().__new__(cls, message)
        self.code = code
        self.funnel = funnel
        return self


# -- the elimination funnel --------------------------------------------------

def domain_level_aggregates(
    ids: np.ndarray, nd: int, sched: np.ndarray, fm: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Gang-independent per-domain aggregates of one topology level:
    (sched_cnt [nd], dom_free [nd, R]) from the masked free matrix `fm`
    and the schedulable mask."""
    sched_cnt = np.bincount(ids, weights=sched, minlength=nd)
    dom_free = np.empty((nd, fm.shape[1]), dtype=np.float64)
    for r in range(fm.shape[1]):
        dom_free[:, r] = np.bincount(
            ids, weights=fm[:, r], minlength=nd
        )
    return sched_cnt, dom_free


def classify_domain_cuts(
    td: np.ndarray, dom_free: np.ndarray, sched_cnt: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The cordon/aggregate-capacity cut predicate over one level's
    aggregates: (cordoned, agg_cut, remaining) boolean arrays."""
    agg_ok = (dom_free + _EPS >= td).all(axis=-1)
    cordoned = sched_cnt == 0
    agg_cut = ~cordoned & ~agg_ok
    remaining = ~cordoned & agg_ok
    return cordoned, agg_cut, remaining


def _domain_name(snapshot, level: int, local_id: int) -> str:
    if level < 0:
        return "cluster"
    key = snapshot.level_keys[level]
    try:
        path = snapshot.level_domains[level][local_id]
        return f"{key}={'/'.join(str(p) for p in path)}"
    except (IndexError, AttributeError):
        return f"{key}#{local_id}"


def diagnose_unplaced(gang, snapshot, free: np.ndarray) -> UnsatDiagnosis:
    """Structured diagnosis for one unplaced gang against the residual
    free matrix it actually faced: every candidate domain (all topology
    domains + the virtual cluster root) is attributed to exactly ONE
    elimination -- so the funnel partitions the domain count -- and the
    deepest non-empty funnel stage names the binding constraint."""
    reason = getattr(gang, "unschedulable_reason", None)
    if reason:
        code = getattr(reason, "code", UnsatCode.UNRESOLVED_LEVEL)
        return UnsatDiagnosis(
            str(reason), code=code, funnel=getattr(reason, "funnel", None)
        )
    levels = snapshot.num_levels
    req = int(gang.required_level)
    if req < -1:
        # UNRESOLVED_LEVEL sentinel without a pre-set reason: a hold,
        # never a capacity problem
        return UnsatDiagnosis(
            "required topology level unresolved against this cluster",
            code=UnsatCode.UNRESOLVED_LEVEL,
        )
    sched = snapshot.schedulable
    fm = np.where(sched[:, None], free, 0.0).astype(np.float32)
    td = np.asarray(gang.total_demand(), dtype=np.float32)
    res_names = snapshot.resource_names
    cap_scale = np.maximum(snapshot.capacity.max(axis=0), _EPS)
    sigs = gang.elig_signatures()

    cut = {"topology": 0, "cordoned": 0, "capacity": 0, "eligibility": 0}
    feasible = 0
    binding: Optional[dict] = None
    binding_rel = np.inf  # best (smallest) relative shortfall seen

    for level in range(-1, levels):
        if level < 0:
            ids = np.zeros(snapshot.num_nodes, dtype=np.int64)
            nd = 1
        else:
            ids = snapshot.domain_ids[level]
            nd = int(snapshot.num_domains[level])
        if req >= 0 and level < req:
            # broader than the required pack level (the root included):
            # the hierarchy constraint cuts every domain here
            cut["topology"] += nd
            continue
        sched_cnt, dom_free = domain_level_aggregates(ids, nd, sched, fm)
        shape_fail = np.zeros(nd, dtype=bool)   # some pod fits NO node
        elig_fail = np.zeros(nd, dtype=bool)    # mask was the difference
        sig_raw: list[np.ndarray] = []          # per-sig unmasked fits [nd]
        for dem, mask in sigs:
            node_ok = (fm + _EPS >= dem).all(axis=1) & sched
            raw = np.bincount(ids, weights=node_ok, minlength=nd) > 0
            sig_raw.append(raw)
            if mask is None:
                shape_fail |= ~raw
            else:
                masked = (
                    np.bincount(ids, weights=node_ok & mask, minlength=nd) > 0
                )
                shape_fail |= ~raw
                elig_fail |= raw & ~masked
        cordoned, agg_cut, rem = classify_domain_cuts(
            td, dom_free, sched_cnt
        )
        shape_cut = rem & shape_fail
        elig_cut = rem & ~shape_fail & elig_fail
        ok = rem & ~shape_fail & ~elig_fail
        cut["cordoned"] += int(cordoned.sum())
        cut["capacity"] += int(agg_cut.sum() + shape_cut.sum())
        cut["eligibility"] += int(elig_cut.sum())
        feasible += int(ok.sum())
        # binding resource: of the aggregate-capacity-cut domains, the one
        # closest to feasible; its worst resource is what blocked placement
        for d in np.flatnonzero(agg_cut):
            short = (td - dom_free[d]) / cap_scale
            worst = float(short.max())
            if worst < binding_rel:
                binding_rel = worst
                r = int(np.argmax(short))
                binding = {
                    "resource": res_names[r],
                    "shortfall": round(float(td[r] - dom_free[d][r]), 6),
                    "demand": round(float(td[r]), 6),
                    "free": round(float(dom_free[d][r]), 6),
                    "domain": _domain_name(snapshot, level, int(d)),
                    "granularity": "domain",
                }
        if binding is None and shape_cut.any():
            # node-granularity binding: within the first shape-cut domain,
            # for the first pod class no node there fits, the node CLOSEST
            # to fitting names the resource it actually falls short on
            d = int(np.flatnonzero(shape_cut)[0])
            in_dom = (ids == d) & sched
            for (dem, _mask), raw in zip(sigs, sig_raw):
                if raw[d] or not in_dom.any():
                    continue
                gaps = (dem[None, :] - fm[in_dom]) / cap_scale  # [n, R]
                node = int(np.argmin(gaps.max(axis=1)))
                r = int(np.argmax(gaps[node]))
                have = float(fm[in_dom][node, r])
                binding = {
                    "resource": res_names[r],
                    "shortfall": round(float(dem[r]) - have, 6),
                    "demand": round(float(dem[r]), 6),
                    "free": round(have, 6),
                    "domain": _domain_name(snapshot, level, d),
                    "granularity": "node",
                }
                break

    total = 1 + int(np.asarray(snapshot.num_domains).sum())
    funnel = {
        "domains_total": total,
        "cut": dict(cut),
        "feasible": feasible,
        "binding": binding,
    }
    # the deepest funnel stage that eliminated anything is the verdict
    if feasible > 0:
        code = UnsatCode.CONFLICT
        msg = (
            f"{feasible} domain(s) statically feasible but exact placement "
            "failed in all of them (per-node fragmentation, co-location "
            "constraint groups, or higher-priority contention)"
        )
    elif cut["eligibility"] > 0:
        code = UnsatCode.ELIGIBILITY
        msg = (
            f"eligibility masks (node selectors / untolerated taints) "
            f"exclude every fitting node in {cut['eligibility']} "
            "capacity-feasible domain(s)"
        )
    elif cut["capacity"] > 0:
        code = UnsatCode.CAPACITY
        if binding is not None:
            msg = (
                f"insufficient capacity: nearest candidate {binding['domain']}"
                f" is short {binding['shortfall']:g} {binding['resource']} "
                f"({binding['granularity']} granularity; demand "
                f"{binding['demand']:g}, free {binding['free']:g})"
            )
        else:
            msg = (
                f"insufficient capacity in all {cut['capacity']} candidate "
                "domain(s)"
            )
    elif cut["cordoned"] > 0:
        code = UnsatCode.CORDONED
        msg = (
            f"all {cut['cordoned']} candidate domain(s) have no schedulable "
            "node (cordon / drain / NotReady)"
        )
    else:
        code = UnsatCode.TOPOLOGY
        msg = "the topology hierarchy leaves no candidate domain"
    return UnsatDiagnosis(msg, code=code, funnel=funnel)
