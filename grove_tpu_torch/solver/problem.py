"""Solver-side problem encoding: PodGangs -> dense gang structs.

The counterpart of grove_tpu/solver/problem.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

The operator hands the solver PodGang CRs (the scheduler contract,
scheduler/api/core/v1alpha1/podgang.go in the reference). This module
flattens them into numpy structs: per-pod demand matrices, group ids, and
topology constraint *level indices* resolved against the TopologySnapshot
(constraints arrive as node-label keys, podgang.go:102-118).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..api.podgang import PodGang, TopologyConstraint
from ..observability.explain import UnsatCode, UnsatDiagnosis
from ..topology.encoding import TopologySnapshot

#: Sentinel for a REQUIRED pack level whose label key is absent from the
#: snapshot. Distinct from -1 (unconstrained): a gang demanding packing at a
#: level the cluster doesn't carry must be held, not scheduled best-effort.
UNRESOLVED_LEVEL = -2


@dataclass
class SolverGang:
    """One gang, dense. P pods, R resources (R matches the snapshot)."""

    name: str
    namespace: str
    demand: np.ndarray                 # float32 [P, R]
    pod_names: list[str]               # len P (pod metadata names)
    group_ids: np.ndarray              # int32 [P] — index into groups
    group_names: list[str]
    # Per-group pack levels, resolved to snapshot level indices; -1 = none.
    group_required_level: np.ndarray   # int32 [num_groups]
    group_preferred_level: np.ndarray  # int32 [num_groups]
    # Gang-level pack constraint (PodGangSpec.TopologyConstraint).
    required_level: int = -1
    preferred_level: int = -1
    priority: float = 0.0
    # Tenant fairness weight (grove_tpu/tenancy): orders gangs of EQUAL
    # priority in every solve path's commit order (gang_sort_key) and
    # rides the batched cost tensor as an extra weighted column. 0.0 =
    # no tenant arbitration (the default for every non-tenant workload).
    # Stamped by TenancyManager.annotate, or by a solve's `fairness=`
    # kwarg (engine.solve/dispatch, solve_serial, solve_serial_native).
    fairness: float = 0.0
    # Constraint groups spanning subsets of groups (PCSG co-location inside a
    # base gang, podgang.go:121-132): (member group indices, required_level,
    # preferred_level).
    constraint_groups: list[tuple[list[int], int, int]] = field(default_factory=list)
    # Set when the gang cannot legally be solved at all (e.g. a required
    # pack level is UNRESOLVED_LEVEL); both solve paths report it unplaced
    # with this reason instead of scheduling it unconstrained.
    unschedulable_reason: Optional[str] = None
    # Per-pod node-eligibility masks (node_selector + taint tolerations):
    # None = every pod unconstrained; else len-P list whose entries are
    # shared read-only bool [N] arrays from TopologySnapshot.eligibility
    # (or None for an individually unconstrained pod). Hard filter —
    # enforced exactly by fit.py and priced into the device score.
    pod_elig: Optional[list] = None

    @property
    def num_pods(self) -> int:
        return int(self.demand.shape[0])

    def total_demand(self) -> np.ndarray:
        # cached: demand is frozen after construction, and the encode
        # phase sums it once per gang per solve (measurable at 10^3-gang
        # backlogs resolved repeatedly)
        td = getattr(self, "_total_demand", None)
        if td is None:
            td = self.demand.sum(axis=0)
            object.__setattr__(self, "_total_demand", td)
        return td

    def max_pod_demand(self) -> np.ndarray:
        return self.demand.max(axis=0) if self.num_pods else self.demand.sum(axis=0)

    def elig_signatures(self) -> list:
        """(max-pod demand, eligibility mask) pairs, one per distinct mask
        class in the gang — the node-granularity fit proxy every
        aggregate-level consumer shares: the device score
        (engine._gang_signatures), the unsat-diagnosis funnel
        (observability/explain.py) and the hierarchical pruner
        (solver/hierarchy.py) must classify nodes with the SAME
        signature set or their verdicts could disagree. Cached: demand
        and pod_elig are frozen after construction, and the coarse pass
        reads this once per gang per solve."""
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

    def sig_max_demand(self) -> np.ndarray:
        """Elementwise max over the signature demands — the fit upper
        bound the hierarchical pruner compares against per-domain max
        node free (a domain where some resource can't satisfy this on
        any node fits no signature). Cached like total_demand: the
        coarse pass reads it once per gang per solve."""
        m = getattr(self, "_sig_max", None)
        if m is None:
            m = np.max(
                [dem for dem, _mask in self.elig_signatures()], axis=0
            )
            object.__setattr__(self, "_sig_max", m)
        return m


def _resolve_level(
    tc: Optional[TopologyConstraint], snapshot: TopologySnapshot
) -> tuple[int, int]:
    """TopologyConstraint (label keys) -> (required_level, preferred_level).

    An unknown PREFERRED key resolves to -1 (a preference for a missing
    level is simply unsatisfiable, so it is dropped). An unknown REQUIRED
    key resolves to UNRESOLVED_LEVEL: a hard constraint must never be
    silently weakened to best-effort — encode_podgangs marks such gangs
    unschedulable and the scheduler holds them with a reason (the operator
    side additionally surfaces TopologyLevelsUnavailable on the PCS).
    """
    req = pref = -1
    if tc is not None and tc.pack_constraint is not None:
        pc = tc.pack_constraint
        if pc.required is not None:
            try:
                req = snapshot.level_index(pc.required)
            except KeyError:
                req = UNRESOLVED_LEVEL
        if pc.preferred is not None:
            try:
                pref = snapshot.level_index(pc.preferred)
            except KeyError:
                pref = -1
    return req, pref


def pod_eligibility_mask(
    snapshot: TopologySnapshot,
    scheduling: Optional[tuple],
    has_taints: bool,
) -> Optional[np.ndarray]:
    """(node_selector, tolerations) -> shared eligibility mask, or None when
    the pod is effectively unconstrained: no selector and no cluster taints,
    or a computed mask that excludes nothing (e.g. every taint tolerated).
    Returning None for all-True masks keeps unconstrained backlogs on the
    fast paths (native C++ repair, single-signature device scoring).

    The single mask-derivation point for both the backlog encode and the
    scheduler's best-effort singles — eligibility semantics must not
    diverge between them.

    Node LIFECYCLE exclusion (cordoned / deleting / NotReady nodes) is NOT
    folded into these masks: it lives in `snapshot.schedulable`, which
    encode_topology derives from the same Node objects (including the
    Ready condition the NodeMonitor maintains) and which every solve path
    — serial candidates, device free-matrix zeroing, reservation reuse,
    best-effort singles, preemption trials — applies unconditionally.
    Keeping the two orthogonal means a single NotReady node can never
    force per-pod masks onto an otherwise unconstrained backlog (which
    would knock it off the fast paths cluster-wide)."""
    if scheduling is None:
        return None
    selector, tolerations = scheduling
    if not selector and not has_taints:
        return None
    mask = snapshot.eligibility(selector, tolerations)
    if mask.all():
        return None
    return mask


def dedupe_pod_masks(
    gangs: list[SolverGang],
) -> tuple[list[np.ndarray], np.ndarray]:
    """Flatten per-pod eligibility masks across a gang list into unique
    rows + a per-pod row index (-1 = unconstrained). Masks are shared
    read-only arrays (snapshot.eligibility cache), so identity dedup keeps
    the row count tiny. The ONE home of this encoding — the native ctypes
    wrapper and the service codec both ship masks this way."""
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


def encode_podgangs(
    podgangs: list[PodGang],
    snapshot: TopologySnapshot,
    pod_demand: Callable[[str, str], Optional[np.ndarray]],
    priority_of: Callable[[PodGang], float] = lambda pg: 0.0,
    pod_scheduling: Optional[Callable[[str, str], Optional[tuple]]] = None,
) -> list[SolverGang]:
    """Flatten PodGang CRs into SolverGangs.

    pod_demand(namespace, name) returns the pod's resource-request vector
    aligned with snapshot.resource_names, or None if the pod doesn't exist
    yet (the gang is then skipped — the operator only creates PodGangs once
    all member pods exist, reference podgang/syncflow.go:435-502, so a
    missing pod means a stale gang).

    pod_scheduling(namespace, name) -> (node_selector dict, tolerations
    list) supplies the pod's hard node filters; when absent all pods are
    unconstrained. A pod needs a mask when it carries a selector OR the
    cluster carries any taint (untolerated taints repel selector-less pods
    too).

    Only the first min_replicas pod references of each PodGroup are encoded:
    those form the all-or-nothing gang; pods beyond the threshold are
    scheduled best-effort by later solve rounds once the gang is placed.
    """
    has_taints = snapshot.has_taints
    gangs: list[SolverGang] = []
    for pg in podgangs:
        demands: list[np.ndarray] = []
        pod_names: list[str] = []
        pod_elig: list = []
        any_elig = False
        group_ids: list[int] = []
        group_names: list[str] = []
        group_req: list[int] = []
        group_pref: list[int] = []
        unresolved: list[str] = []

        def resolve(tc):
            req, pref = _resolve_level(tc, snapshot)
            if req == UNRESOLVED_LEVEL:
                # strip the operator-side sentinel prefix so status messages
                # show the domain the user actually wrote
                unresolved.append(
                    tc.pack_constraint.required.removeprefix("unresolved:")
                )
            return req, pref

        stale = False
        for gi, group in enumerate(pg.spec.pod_groups):
            group_names.append(group.name)
            req, pref = resolve(group.topology_constraint)
            group_req.append(req)
            group_pref.append(pref)
            for ref in group.pod_references[: group.min_replicas]:
                d = pod_demand(ref.namespace, ref.name)
                if d is None:
                    stale = True
                    break
                demands.append(np.asarray(d, dtype=np.float32))
                pod_names.append(ref.name)
                group_ids.append(gi)
                mask = None
                if pod_scheduling is not None:
                    mask = pod_eligibility_mask(
                        snapshot,
                        pod_scheduling(ref.namespace, ref.name),
                        has_taints,
                    )
                    if mask is not None:
                        any_elig = True
                pod_elig.append(mask)
            if stale:
                break
        if stale or not demands:
            continue
        req, pref = resolve(pg.spec.topology_constraint)
        name_to_idx = {n: i for i, n in enumerate(group_names)}
        cgroups: list[tuple[list[int], int, int]] = []
        for cg in pg.spec.topology_constraint_group_configs:
            members = [name_to_idx[n] for n in cg.pod_group_names if n in name_to_idx]
            cg_req, cg_pref = resolve(cg.topology_constraint)
            if members and (cg_req >= 0 or cg_pref >= 0):
                cgroups.append((members, cg_req, cg_pref))
        reason = None
        if unresolved:
            # structured: the scheduler/status surfaces key off the code
            # (a hold, never a capacity problem — preemption is futile);
            # the str content stays the operator-facing message
            reason = UnsatDiagnosis(
                "required topology level(s) unavailable: "
                + ",".join(sorted(set(unresolved))),
                code=UnsatCode.UNRESOLVED_LEVEL,
            )
        gangs.append(
            SolverGang(
                name=pg.metadata.name,
                namespace=pg.metadata.namespace,
                demand=np.stack(demands).astype(np.float32),
                pod_names=pod_names,
                group_ids=np.asarray(group_ids, dtype=np.int32),
                group_names=group_names,
                group_required_level=np.asarray(group_req, dtype=np.int32),
                group_preferred_level=np.asarray(group_pref, dtype=np.int32),
                required_level=req,
                preferred_level=pref,
                priority=priority_of(pg),
                constraint_groups=cgroups,
                unschedulable_reason=reason,
                pod_elig=pod_elig if any_elig else None,
            )
        )
    return gangs
