"""Carry a cluster and a backlog across from the JAX package.

The solve has no learned weights; what it needs from the other package is
its inputs: a topology snapshot and solver gangs. These functions take the
plain numpy arrays and lists those objects hold, field by field, so this
package never imports grove_tpu:

    snap = snapshot_from_arrays(**{f: getattr(jax_snap, f) for f in SNAPSHOT_FIELDS})
    gang = gang_from_arrays(**{f: getattr(jax_gang, f) for f in GANG_FIELDS})

Arrays are copied; per-pod eligibility masks are passed through as the
same objects, because the engine dedupes masks by identity.
"""

from __future__ import annotations

import numpy as np

from .observability.explain import UnsatCode, UnsatDiagnosis
from .solver.problem import SolverGang
from .topology.encoding import TopologySnapshot

SNAPSHOT_FIELDS = (
    "level_keys", "level_domains", "domain_ids", "num_domains", "node_names",
    "resource_names", "capacity", "free", "schedulable", "node_labels",
    "node_taints",
)

GANG_FIELDS = (
    "name", "namespace", "demand", "pod_names", "group_ids", "group_names",
    "group_required_level", "group_preferred_level", "required_level",
    "preferred_level", "priority", "fairness", "constraint_groups",
    "unschedulable_reason", "pod_elig",
)


def snapshot_from_arrays(
    level_keys, level_domains, domain_ids, num_domains, node_names,
    resource_names, capacity, free, schedulable, node_labels=(),
    node_taints=(),
) -> TopologySnapshot:
    """A TopologySnapshot from its fields' plain values."""
    names = list(node_names)
    return TopologySnapshot(
        level_keys=list(level_keys),
        level_domains=[list(doms) for doms in level_domains],
        domain_ids=np.array(domain_ids, dtype=np.int32),
        num_domains=np.array(num_domains, dtype=np.int32),
        node_names=names,
        node_index={n: i for i, n in enumerate(names)},
        resource_names=list(resource_names),
        capacity=np.array(capacity, dtype=np.float32),
        free=np.array(free, dtype=np.float32),
        schedulable=np.array(schedulable, dtype=bool),
        node_labels=[dict(lb) for lb in node_labels],
        node_taints=[list(t) for t in node_taints],
    )


def _reason(reason):
    """An unschedulable reason: a str, or a str carrying `.code` (whose
    value names an UnsatCode) and `.funnel`."""
    if reason is None:
        return None
    code = getattr(reason, "code", None)
    if code is None:
        return str(reason)
    return UnsatDiagnosis(
        str(reason), code=UnsatCode(getattr(code, "value", code)),
        funnel=getattr(reason, "funnel", None),
    )


def gang_from_arrays(
    name, namespace, demand, pod_names, group_ids, group_names,
    group_required_level, group_preferred_level, required_level=-1,
    preferred_level=-1, priority=0.0, fairness=0.0, constraint_groups=(),
    unschedulable_reason=None, pod_elig=None,
) -> SolverGang:
    """A SolverGang from its fields' plain values."""
    return SolverGang(
        name=str(name),
        namespace=str(namespace),
        demand=np.array(demand, dtype=np.float32),
        pod_names=list(pod_names),
        group_ids=np.array(group_ids, dtype=np.int32),
        group_names=list(group_names),
        group_required_level=np.array(group_required_level, dtype=np.int32),
        group_preferred_level=np.array(group_preferred_level, dtype=np.int32),
        required_level=int(required_level),
        preferred_level=int(preferred_level),
        priority=float(priority),
        fairness=float(fairness),
        constraint_groups=[
            (list(members), int(req), int(pref))
            for members, req, pref in constraint_groups
        ],
        unschedulable_reason=_reason(unschedulable_reason),
        pod_elig=None if pod_elig is None else list(pod_elig),
    )
