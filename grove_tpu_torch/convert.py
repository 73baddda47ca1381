"""Carry a cluster and a backlog across from the JAX package.

The solve has no learned weights; what it needs from the other package is
its inputs: a topology snapshot and solver gangs. These functions take the
plain numpy arrays and lists those objects hold, field by field, so this
package never imports grove_tpu:

    snap = snapshot_from_arrays(**{f: getattr(jax_snap, f) for f in SNAPSHOT_FIELDS})
    gang = gang_from_arrays(**{f: getattr(jax_gang, f) for f in GANG_FIELDS})

Arrays are copied; per-pod eligibility masks are passed through as the
same objects, because the engine dedupes masks by identity.

The control plane's inputs are API objects (Node, Pod, PodGang,
ClusterTopology, PriorityClass, an OperatorConfig) or config dicts;
`api_object` carries any of them into this package's classes:

    nodes = [api_object(n) for n in jax_nodes]
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .api import auxiliary, config, meta, podgang, types
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


def _api_classes() -> dict[str, type]:
    """This package's API dataclasses and enums by class name (the names
    are unique across its API modules)."""
    out = {}
    for mod in (meta, types, podgang, auxiliary, config):
        for name, obj in vars(mod).items():
            if (isinstance(obj, type) and obj.__module__ == mod.__name__
                    and (dataclasses.is_dataclass(obj)
                         or issubclass(obj, enum.Enum))):
                out[name] = obj
    return out


_API_CLASSES = _api_classes()


def api_object(obj):
    """`obj` as this package's object: a dataclass becomes the class of
    the same name in this package's `api`, built from its fields by name
    (each carried across in turn); an enum member becomes the member of
    the same value; dicts, lists and tuples are copied with their items
    carried across; numpy arrays are copied; other values pass through.
    A config dict comes back as a dict, ready for
    `api.config.load_operator_config`."""
    if isinstance(obj, enum.Enum):
        return _API_CLASSES[type(obj).__name__](obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _API_CLASSES[type(obj).__name__]
        return cls(**{f.name: api_object(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {api_object(k): api_object(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [api_object(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(api_object(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj
