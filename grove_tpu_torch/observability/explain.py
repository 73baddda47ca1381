"""Placement explainability: structured unsat diagnosis, score
decomposition, and the scheduler decision audit log.

The counterpart of grove_tpu/observability/explain.py, its CLI included
(`python -m grove_tpu_torch.observability.explain`); the CLI's demo runs
its Harness on the CUDA card unless `--device cpu` is given. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

The reference's scheduling contract is an opaque handoff — a PodGang is
Scheduled or carries a one-line unschedulable string (the score semantics
in podgang.go:177-179 are all the explanation a user ever gets). This
module makes "why is my gang pending?" and "why did it land there?"
first-class queryable facts:

  UnsatCode / UnsatDiagnosis — the shared reason-code vocabulary every
      solve path emits for an unplaced gang. UnsatDiagnosis subclasses
      str, so every existing consumer of the free-form reason message
      (status conditions, events, logs, the service codec) keeps working
      while structured consumers key off `.code` — which kills the
      scheduler's "no feasible domain" magic-string match.
  diagnose_unplaced() — the candidate-domain elimination FUNNEL: every
      topology domain (plus the virtual cluster root) is attributed to
      exactly one cut — topology hierarchy, cordon/NotReady exclusion,
      capacity (aggregate or node-shape, with the binding resource and
      its shortfall), eligibility masks — or survives as statically
      feasible. The funnel partitions the domain count exactly.
  score_decomposition() — the per-term breakdown behind the scalar
      placement_score: one additive term per topology level, terms
      recombining exactly to the score, each annotated with how many
      domains the gang spans at that level (the "why not higher" fact).
  DecisionLog / DecisionRecord — a bounded per-gang ring of solve
      outcomes (placed decisions with their decomposition, unplaced
      decisions with their diagnosis, preemption attempts with the
      victims considered and why rejected ones were rejected), populated
      by every PlacementEngine solve and surfaced through
      debug_dump()["explain"], the gRPC Debug service, and chaos
      postmortems.

Everything here runs on HOST numpy from state the solve already
materialized — the device phase ships no extra tensors, and the funnel is
computed only for unplaced gangs (the rare case), so explain recording
stays off the hot device path.

"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np

_EPS = 1e-6


class UnsatCode(str, Enum):
    """Machine-readable unplaced-gang reason codes, shared by
    solver/serial.py, solver/engine.py, native/serial_native.py and the
    scheduler (condition reasons, the grove_scheduler_unplaced_total
    metric, preemption eligibility)."""

    #: a required pack level's label key is absent from the topology —
    #: a hold, not a capacity problem; preemption can never help
    UNRESOLVED_LEVEL = "UnresolvedTopologyLevel"
    #: no candidate domain has the capacity (aggregate free short of the
    #: gang's total demand, or no single node fits the largest pod)
    CAPACITY = "InsufficientCapacity"
    #: capacity exists, but node selectors / untolerated taints exclude
    #: every node that would fit
    ELIGIBILITY = "EligibilityExcluded"
    #: every candidate domain lost all its schedulable nodes to
    #: cordon / drain / NotReady exclusion
    CORDONED = "NodesUnavailable"
    #: the topology hierarchy itself cut every domain (no domain exists
    #: at or below the required pack level)
    TOPOLOGY = "TopologyConstrained"
    #: statically-feasible domains existed but exact placement failed in
    #: all of them — per-node fragmentation, co-location constraint
    #: groups, or contention with higher-priority gangs in the same solve
    CONFLICT = "PlacementConflict"
    #: tenant admission shed the gang: its tenant queue (or an ancestor
    #: queue) would exceed its burst quota — load shedding, not a
    #: capacity problem of the cluster (grove_tpu/tenancy)
    QUOTA = "QuotaExceeded"
    #: the legacy magic string from a custom/older engine (kept
    #: preemption-eligible so external engines retain old behavior)
    NO_FEASIBLE_DOMAIN = "NoFeasibleDomain"
    #: the federation router cut every member cluster (the same coarse
    #: cordon/aggregate/fit predicates the hierarchical pruner runs,
    #: one level up — grove_tpu/federation); the gang never reached any
    #: cluster's control plane
    NO_FEASIBLE_CLUSTER = "NoFeasibleCluster"
    #: the streaming admission front shed the gang: its projected queue
    #: wait (or measured queue depth under brownout) exceeded the
    #: declared SLO budget — overload backpressure, not a capacity or
    #: feasibility fact about the cluster (grove_tpu/streaming)
    DEADLINE = "DeadlineExceeded"


#: codes for which priority preemption could plausibly free usable
#: capacity. UNRESOLVED_LEVEL is a topology hold (evicting anything cannot
#: materialize a missing label key), so it is excluded — the same rule the
#: scheduler previously expressed by string-matching "no feasible domain".
#: QUOTA is excluded too: a shed gang is over its own tenant's quota, and
#: evicting other tenants' work cannot lower that tenant's usage of it —
#: preemption on a shed gang would just destroy victims for nothing.
#: NO_FEASIBLE_CLUSTER is excluded for the same structural reason as
#: UNRESOLVED_LEVEL: the gang was cut ABOVE every cluster's control
#: plane, so no in-cluster eviction pass can run for it — only the
#: federation router retrying against refreshed aggregates can admit it.
#: DEADLINE is excluded like QUOTA: a shed is admission-queue overload
#: backpressure — evicting placed work cannot shorten the admission
#: queue, and the stream re-admits the gang itself once depth recovers.
PREEMPTIBLE_CODES = frozenset(
    (
        UnsatCode.CAPACITY,
        UnsatCode.ELIGIBILITY,
        UnsatCode.CORDONED,
        UnsatCode.TOPOLOGY,
        UnsatCode.CONFLICT,
        UnsatCode.NO_FEASIBLE_DOMAIN,
    )
)

#: the pre-explainability magic string (solver/serial.py, engine.py,
#: native/serial_native.py all emitted it; the scheduler string-matched
#: it). Recognized for custom engines that still produce it.
LEGACY_NO_FEASIBLE = "no feasible domain"


class UnsatDiagnosis(str):
    """An unplaced-gang reason: a human-readable message that IS a str
    (every legacy consumer — conditions, events, codec, logging, tests
    comparing messages — keeps working) carrying the structured
    `.code` and the candidate-domain elimination `.funnel`."""

    code: UnsatCode
    funnel: Optional[dict]

    def __new__(cls, message: str, code: UnsatCode = UnsatCode.NO_FEASIBLE_DOMAIN,
                funnel: Optional[dict] = None):
        self = super().__new__(cls, message)
        self.code = code
        self.funnel = funnel
        return self

    def to_dict(self) -> dict:
        return {
            "message": str(self),
            "code": self.code.value,
            "funnel": self.funnel,
        }


def unsat_code(reason) -> Optional[UnsatCode]:
    """The structured code of an unplaced reason, or None for a free-form
    string no code maps to (a custom engine's private vocabulary)."""
    code = getattr(reason, "code", None)
    if code is not None:
        return code
    if str(reason) == LEGACY_NO_FEASIBLE:
        return UnsatCode.NO_FEASIBLE_DOMAIN
    return None


def unsat_preemptible(reason) -> bool:
    """Whether priority preemption is worth attempting for this reason —
    the structured replacement for the scheduler's magic-string match."""
    code = unsat_code(reason)
    return code is not None and code in PREEMPTIBLE_CODES


# -- the elimination funnel --------------------------------------------------

def _gang_signatures(gang) -> list[tuple[np.ndarray, Optional[np.ndarray]]]:
    """(max-pod demand, eligibility mask) pairs, one per distinct mask
    class in the gang — the same node-granularity proxy the device score
    uses (engine._gang_signatures), host-side and per-gang. Delegates to
    SolverGang.elig_signatures (the canonical, cached implementation);
    the inline fallback keeps duck-typed test gangs working."""
    sig_fn = getattr(gang, "elig_signatures", None)
    if sig_fn is not None:
        return sig_fn()
    if gang.pod_elig is None:
        return [(gang.max_pod_demand(), None)]
    by_mask: dict[int, tuple[np.ndarray, Optional[np.ndarray]]] = {}
    for p in range(gang.num_pods):
        mask = gang.pod_elig[p]
        key = 0 if mask is None else id(mask)
        cur = by_mask.get(key)
        dem = gang.demand[p]
        by_mask[key] = (
            dem if cur is None else np.maximum(cur[0], dem),
            mask,
        )
    return list(by_mask.values())


def domain_level_aggregates(
    ids: np.ndarray, nd: int, sched: np.ndarray, fm: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Gang-independent per-domain aggregates of one topology level:
    (sched_cnt [nd], dom_free [nd, R]) from the masked free matrix `fm`
    and the schedulable mask. The ONE aggregation both consumers of the
    elimination structure run — the unsat-diagnosis funnel below and the
    hierarchical pruner (solver/hierarchy.py) — so a domain can never be
    'cut' by one and 'aggregate-feasible' by the other."""
    sched_cnt = np.bincount(ids, weights=sched, minlength=nd)
    # per-resource bincount instead of one np.add.at: same in-order
    # float64 accumulation, several times faster at 100k nodes (R is
    # tiny and static)
    dom_free = np.empty((nd, fm.shape[1]), dtype=np.float64)
    for r in range(fm.shape[1]):
        dom_free[:, r] = np.bincount(
            ids, weights=fm[:, r], minlength=nd
        )
    return sched_cnt, dom_free


def classify_domain_cuts(
    td: np.ndarray, dom_free: np.ndarray, sched_cnt: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The shared cordon/aggregate-capacity cut predicate over one
    level's aggregates: (cordoned, agg_cut, remaining) boolean arrays.
    Broadcasts — `td` may be one gang's [R] demand (the funnel) or a
    whole backlog's [G, 1, R] against dom_free [nd, R] (the pruner), so
    diagnosis and pruning literally evaluate the same expression."""
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
    elimination — so the funnel partitions the domain count — and the
    deepest non-empty funnel stage names the binding constraint.

    `free` is the residual matrix at the end of the solve (gangs commit
    in priority order, so for an unplaced gang this matches the capacity
    it was scored against up to lower-priority commits). Cost: a few
    numpy passes over [N, R] per level, paid only for unplaced gangs."""
    reason = getattr(gang, "unschedulable_reason", None)
    if reason:
        code = getattr(reason, "code", UnsatCode.UNRESOLVED_LEVEL)
        return UnsatDiagnosis(
            str(reason), code=code, funnel=getattr(reason, "funnel", None)
        )
    levels = snapshot.num_levels
    req = int(gang.required_level)
    if req < -1:
        # UNRESOLVED_LEVEL sentinel without a pre-set reason (hand-built
        # SolverGangs): still a hold, never a capacity problem
        return UnsatDiagnosis(
            "required topology level unresolved against this cluster",
            code=UnsatCode.UNRESOLVED_LEVEL,
        )
    sched = snapshot.schedulable
    fm = np.where(sched[:, None], free, 0.0).astype(np.float32)
    td = np.asarray(gang.total_demand(), dtype=np.float32)
    res_names = snapshot.resource_names
    cap_scale = np.maximum(snapshot.capacity.max(axis=0), _EPS)
    sigs = _gang_signatures(gang)

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
            # to fitting names the resource it actually falls short on —
            # resources are never mixed across nodes
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


# -- score decomposition -----------------------------------------------------

def domain_spans(domain_ids: np.ndarray,
                 node_indices: np.ndarray) -> list[int]:
    """Per-level distinct-domain counts of a node set over a [L, N]
    domain table — the compact core of a score decomposition (ONE fancy
    index for all levels). The single implementation shared by
    score_decomposition and DecisionRecord.to_dict."""
    levels = int(domain_ids.shape[0])
    if levels == 0 or len(node_indices) == 0:
        return [1] * levels
    ids = domain_ids[:, np.asarray(node_indices)]  # [L, P]
    return [len(set(row.tolist())) for row in ids]


def expand_decomposition(spans: list[int], level_keys: list[str]) -> dict:
    """Spans -> the full per-term breakdown behind
    placement_score_for_nodes' scalar.

    The score is (narrowest + 2) / (levels + 1): one base term for the
    cluster root plus one equal term per topology level the gang packs
    into a single domain of. The terms recombine EXACTLY to the scalar;
    unsatisfied levels carry their contribution as `lost` plus the
    number of domains the gang actually spans there — the answer to
    "why is the score not higher". Expansion is deferred to dump/render
    time (DecisionRecord.to_dict) so the per-solve recording cost stays
    at the spans computation."""
    levels = len(spans)
    unit = 1.0 / (levels + 1)
    narrowest = -1
    for level in range(levels - 1, -1, -1):
        if spans[level] == 1:
            narrowest = level
            break
    terms: list[dict] = [
        {
            "term": "cluster",
            "satisfied": True,
            "domains_spanned": 1,
            "contribution": unit,
            "lost": 0.0,
        }
    ]
    for level in range(levels):
        satisfied = level <= narrowest
        terms.append(
            {
                "term": f"packed@{level_keys[level]}",
                "level": level,
                "satisfied": satisfied,
                "domains_spanned": spans[level],
                "contribution": unit if satisfied else 0.0,
                "lost": 0.0 if satisfied else unit,
            }
        )
    return {"score": (narrowest + 2) * unit, "terms": terms}


def score_decomposition(snapshot, node_indices: np.ndarray) -> dict:
    """Per-term breakdown behind placement_score_for_nodes' scalar (see
    expand_decomposition for the term semantics)."""
    return expand_decomposition(
        domain_spans(snapshot.domain_ids, node_indices), snapshot.level_keys
    )


# -- the decision audit log --------------------------------------------------

@dataclass
class DecisionRecord:
    """One solve outcome for one gang. `detail` is outcome-shaped:
    placed -> {score, pods, decomposition}; unplaced -> {code, message,
    funnel}. `preemption` is attached by the scheduler when an eviction
    round ran for (or against) this gang.

    Placed records defer the decomposition entirely: they hold a
    REFERENCE to the placement's node-index array plus the (static,
    shared) snapshot, and compute spans + terms only in to_dict() —
    recording runs per placed gang per solve and must stay O(1); dumps
    run at debug/render time."""

    namespace: str
    gang: str
    outcome: str                      # "placed" | "unplaced"
    wall_time: float
    detail: dict = field(default_factory=dict)
    preemption: Optional[dict] = None

    def to_dict(self) -> dict:
        detail = self.detail
        if "_nodes" in detail:
            nodes = detail["_nodes"]
            domain_ids, level_keys = detail["_domains"]
            detail = {
                k: v for k, v in detail.items()
                if k not in ("_nodes", "_domains")
            }
            detail["decomposition"] = expand_decomposition(
                domain_spans(domain_ids, nodes), level_keys
            )
        out = {
            "namespace": self.namespace,
            "gang": self.gang,
            "outcome": self.outcome,
            "wall_time": self.wall_time,
            "detail": detail,
        }
        if self.preemption is not None:
            out["preemption"] = self.preemption
        return out


class DecisionLog:
    """Bounded per-gang ring of DecisionRecords.

    At most `max_gangs` gangs are tracked (LRU eviction — recording for a
    gang refreshes its recency) and each keeps its last `per_gang`
    records, so memory is fixed at any run length. Population is O(1)
    appends off the device path; the funnel/decomposition payloads are
    computed host-side by the solve that produced them."""

    MAX_GANGS = 4096
    PER_GANG = 4

    def __init__(self, max_gangs: int | None = None,
                 per_gang: int | None = None):
        self.max_gangs = max_gangs or self.MAX_GANGS
        self.per_gang = per_gang or self.PER_GANG
        self._rings: OrderedDict[tuple[str, str], deque] = OrderedDict()
        self.records_total = 0

    def __len__(self) -> int:
        return len(self._rings)

    def record(self, rec: DecisionRecord) -> None:
        key = (rec.namespace, rec.gang)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.per_gang)
        else:
            self._rings.move_to_end(key)
        ring.append(rec)
        self.records_total += 1
        while len(self._rings) > self.max_gangs:
            self._rings.popitem(last=False)

    def record_solve(self, result, snapshot, gangs=None) -> None:
        """Feed one SolveResult into the ring — called by every
        PlacementEngine solve path (and the service's engines), so no
        placement decision is invisible to explain(). `gangs` (the
        solved SolverGang list) resolves namespaces for unplaced gangs;
        placed gangs carry theirs on the placement."""
        now = time.time()
        ns_of = (
            {g.name: g.namespace for g in gangs} if gangs is not None else {}
        )
        # one shared tuple per solve: records pin only the (static)
        # domain table + level names, never the whole snapshot with its
        # free matrix and caches
        domains = (snapshot.domain_ids, snapshot.level_keys)
        for name, placement in result.placed.items():
            self.record(
                DecisionRecord(
                    namespace=getattr(placement.gang, "namespace", ""),
                    gang=name,
                    outcome="placed",
                    wall_time=now,
                    detail={
                        "score": float(placement.placement_score),
                        "pods": int(len(placement.node_indices)),
                        # deferred decomposition: references only (the
                        # node array is placement-owned, the domain
                        # encoding is static) — expanded by to_dict()
                        # at dump/render time
                        "_nodes": placement.node_indices,
                        "_domains": domains,
                    },
                )
            )
        for name, reason in result.unplaced.items():
            code = unsat_code(reason)
            self.record(
                DecisionRecord(
                    namespace=ns_of.get(name, ""),
                    gang=name,
                    outcome="unplaced",
                    wall_time=now,
                    detail={
                        "code": code.value if code is not None else None,
                        "message": str(reason),
                        "funnel": getattr(reason, "funnel", None),
                    },
                )
            )

    def attach_preemption(self, namespace: str, gang: str,
                          info: dict) -> None:
        """Stamp a preemption attempt onto the gang's latest record
        (creating a bare record when the solve's record was evicted)."""
        ring = self._rings.get((namespace, gang))
        if ring is None or not ring:
            self.record(
                DecisionRecord(
                    namespace=namespace, gang=gang, outcome="unplaced",
                    wall_time=time.time(), detail={}, preemption=info,
                )
            )
            return
        ring[-1].preemption = info

    def attach_migration(self, namespace: str, gang: str,
                         info: dict) -> None:
        """Record one defragmentation candidate verdict — admitted OR
        rejected — as a migration audit record. Unlike attach_preemption
        (which annotates the latest solve record), a migration decision
        is its own event: the gang was PLACED when the defragmenter
        examined it, and the audit must survive the re-solve records the
        executed move generates. `info` carries the defragmenter's full
        arithmetic: current/candidate score, gain, migration cost,
        budget state (which consumer spent what), and the verdict."""
        self.record(
            DecisionRecord(
                namespace=namespace, gang=gang, outcome="migration",
                wall_time=time.time(), detail=info,
            )
        )

    def explain(self, namespace: str, gang: str) -> Optional[dict]:
        """The full decision history of one gang (newest last), or None
        when the ring never saw it (or already evicted it)."""
        ring = self._rings.get((namespace, gang))
        if ring is None:
            # gangs recorded without a namespace (direct solver use)
            ring = self._rings.get(("", gang))
        if ring is None:
            return None
        return {
            "gang": f"{namespace + '/' if namespace else ''}{gang}",
            "records": [r.to_dict() for r in ring],
        }

    def summary(self) -> dict:
        """The debug_dump()["explain"] payload: ring occupancy plus the
        latest record of every gang whose LAST decision was unplaced —
        the actionable set — bounded by the ring itself."""
        pending = {}
        for (ns, name), ring in self._rings.items():
            if ring and ring[-1].outcome == "unplaced":
                pending[f"{ns + '/' if ns else ''}{name}"] = (
                    ring[-1].to_dict()
                )
        return {
            "gangs_tracked": len(self._rings),
            "records_total": self.records_total,
            "max_gangs": self.max_gangs,
            "per_gang": self.per_gang,
            "unplaced": pending,
        }


# -- rendering ---------------------------------------------------------------

def render_verdict(entry: dict) -> str:
    """Human-readable verdict for one explain() entry (or one
    summary()["unplaced"] record wrapped as {"records": [rec]})."""
    lines: list[str] = []
    records = entry.get("records") or []
    name = entry.get("gang", "?")
    if not records:
        return f"gang {name}: no recorded decisions"
    rec = records[-1]
    detail = rec.get("detail", {})
    if rec.get("outcome") == "placed":
        lines.append(
            f"gang {name}: PLACED  score={detail.get('score', 0.0):.3f}"
            f"  pods={detail.get('pods', '?')}"
        )
        decomp = detail.get("decomposition") or {}
        for term in decomp.get("terms", []):
            if term.get("satisfied"):
                lines.append(
                    f"  + {term['contribution']:.3f}  {term['term']}"
                )
            else:
                lines.append(
                    f"  - {term['lost']:.3f}  {term['term']} unsatisfied "
                    f"(spans {term['domains_spanned']} domains)"
                )
    elif rec.get("outcome") == "migration":
        # a defragmentation audit record (controller/defrag.py): the
        # gang was PLACED when examined; the verdict is the story
        lines.append(
            f"gang {name}: MIGRATION {detail.get('verdict', '?')}  "
            f"score {detail.get('current_score', '?')} -> "
            f"{detail.get('candidate_score', '?')}  "
            f"net_gain={detail.get('net_gain', '?')} "
            f"(threshold {detail.get('threshold', '?')})"
        )
        if detail.get("from"):
            lines.append(f"  from {','.join(detail['from'])}")
        if detail.get("to"):
            lines.append(f"  to   {','.join(detail['to'])}")
        if detail.get("budget"):
            b = detail["budget"]
            lines.append(
                f"  budget: limit {b.get('limit')} "
                f"spent_by {b.get('spent_by')}"
            )
        if detail.get("note"):
            lines.append(f"  {detail['note']}")
    else:
        code = detail.get("code") or "Unknown"
        lines.append(f"gang {name}: UNPLACED  [{code}]")
        if detail.get("message"):
            lines.append(f"  {detail['message']}")
        funnel = detail.get("funnel")
        if funnel and "quota" in funnel:
            q = funnel["quota"]
            lines.append(
                f"  quota: tenant {q.get('tenant', '?')} queue "
                f"{q.get('queue', '?')} over {q.get('band', '?')} on "
                f"{q.get('resource', '?')} (usage {q.get('usage', 0):g} + "
                f"demand {q.get('demand', 0):g} > limit {q.get('limit', 0):g})"
            )
        elif funnel:
            cut = funnel.get("cut", {})
            lines.append(
                f"  funnel: {funnel.get('domains_total', '?')} domains"
                f" | topology -{cut.get('topology', 0)}"
                f" | cordoned -{cut.get('cordoned', 0)}"
                f" | capacity -{cut.get('capacity', 0)}"
                f" | eligibility -{cut.get('eligibility', 0)}"
                f" -> {funnel.get('feasible', 0)} feasible"
            )
            binding = funnel.get("binding")
            if binding:
                lines.append(
                    f"  binding: {binding['resource']} short "
                    f"{binding['shortfall']:g} in {binding['domain']} "
                    f"({binding['granularity']} granularity; demand "
                    f"{binding['demand']:g}, free {binding['free']:g})"
                )
    pre = rec.get("preemption")
    if pre:
        lines.append(
            f"  preemption: considered {len(pre.get('considered', []))} "
            f"victim(s), evicted {len(pre.get('evicted', []))}"
            + (f" ({pre.get('note')})" if pre.get("note") else "")
        )
        for v in pre.get("considered", []):
            lines.append(
                f"    victim {v.get('victim')} (priority "
                f"{v.get('priority')}): {v.get('outcome')}"
            )
    if len(records) > 1:
        lines.append(f"  ({len(records)} recorded decisions; newest shown)")
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------

_DEMOS = ("capacity", "topology", "cordon", "eligibility")


def _demo_harness(scenario: str, seed: int, device=None):
    """A self-contained seeded unsat scenario through the REAL control
    plane (Harness + scheduler + engine), returning the settled harness.
    The seed perturbs the demand so repeated runs exercise different
    shortfalls deterministically. `device` is the engine's (None: the
    CUDA card)."""
    from ..api.meta import ObjectMeta
    from ..api.types import (
        Container,
        PodCliqueSet,
        PodCliqueSetSpec,
        PodCliqueSetTemplateSpec,
        PodCliqueSpec,
        PodCliqueTemplateSpec,
        PodSpec,
        TopologyConstraintSpec,
        TopologyPackConstraintSpec,
    )
    from ..cluster import make_nodes
    from ..controller import Harness

    selector = None
    constraint = None
    if scenario == "capacity":
        # 2 nodes x 4 cpu = 8 free; 3 pods of (3 + seed%3) cpu demand
        # 9/12/15 — always an aggregate-capacity verdict, with the
        # shortfall varying by seed
        node_count, cpu = 2, 3.0 + (seed % 3)
    else:
        # capacity must NOT be the binding stage for the other demos:
        # pods of (1 + seed%3) cpu always fit a 4-cpu node
        node_count, cpu = 4, 1.0 + (seed % 3)
    if scenario == "eligibility":
        selector = {"accel": "v9"}  # no node carries the label
    nodes = make_nodes(node_count, allocatable={"cpu": 4.0, "memory": 8.0,
                                                "tpu": 0.0})
    h = Harness(nodes=nodes, device=device)
    if scenario == "cordon":
        for n in nodes:
            h.cluster.cordon(n.metadata.name)
    if scenario == "topology":
        constraint = TopologyConstraintSpec(
            pack_constraint=TopologyPackConstraintSpec(required="zone")
        )
    pcs = PodCliqueSet(
        metadata=ObjectMeta(name=f"demo-{scenario}"),
        spec=PodCliqueSetSpec(
            replicas=1,
            template=PodCliqueSetTemplateSpec(
                cliques=[
                    PodCliqueTemplateSpec(
                        name="w",
                        spec=PodCliqueSpec(
                            replicas=3,
                            pod_spec=PodSpec(
                                containers=[
                                    Container(
                                        name="main",
                                        resources={"cpu": float(cpu)},
                                    )
                                ],
                                node_selector=selector or {},
                            ),
                        ),
                    )
                ],
            ),
        ),
    )
    if constraint is not None:
        pcs.spec.template.topology_constraint = constraint
    h.apply(pcs)
    h.settle()
    return h


def main(argv=None) -> int:
    """Render placement verdicts from a dump file or a seeded demo
    scenario — the shell entry point of the "Why is my gang pending?"
    runbook (docs/observability.md)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="explain grove placement decisions: why a gang is "
        "pending (reason code + elimination funnel + binding resource) "
        "or why it landed where it did (score decomposition)"
    )
    ap.add_argument("input", nargs="?", default=None,
                    help="JSON dump: harness debug_dump(), its 'explain' "
                    "section, a chaos explain dump, or one explain() entry")
    ap.add_argument("--gang", default=None, metavar="[NS/]NAME",
                    help="only render this gang")
    ap.add_argument("--demo", choices=_DEMOS, default=None,
                    help="run a seeded unsat scenario through the real "
                    "control plane and explain it")
    ap.add_argument("--seed", type=int, default=0,
                    help="demo seed (perturbs the demand)")
    ap.add_argument("--json", action="store_true",
                    help="emit raw JSON instead of rendered verdicts")
    ap.add_argument("--device", default=None,
                    help="where the demo's engine solves: the CUDA card "
                    "unless 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.demo is not None:
        h = _demo_harness(args.demo, args.seed, device=args.device)
        explain = h.debug_dump().get("explain", {})
    elif args.input is not None:
        with open(args.input) as fh:
            data = json.load(fh)
        # accept a full debug dump, its explain section, a chaos explain
        # dump ({gang: explain-entry}), or one explain() entry
        explain = data.get("explain", data) if isinstance(data, dict) else {}
    else:
        ap.error("pass a dump path or --demo")
        return 2

    entries: list[dict] = []
    if "records" in explain:       # a single explain() entry
        entries = [explain]
    elif "unplaced" in explain:    # DecisionLog.summary()
        entries = [
            {"gang": name, "records": [rec]}
            for name, rec in sorted(explain["unplaced"].items())
        ]
    else:                          # {gang: explain-entry} map
        entries = [
            v for v in explain.values()
            if isinstance(v, dict) and "records" in v
        ]
    if args.gang:
        want = args.gang
        entries = [
            e for e in entries
            if e.get("gang") in (want, f"default/{want}")
            or str(e.get("gang", "")).endswith(f"/{want}")
        ]
    if not entries:
        print("no matching decision records")
        return 1
    if args.json:
        print(json.dumps(entries, indent=2))
        return 0
    for entry in entries:
        print(render_verdict(entry))
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI
    raise SystemExit(main())
