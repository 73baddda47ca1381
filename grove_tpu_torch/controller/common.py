"""Shared controller helpers: hashes, labels, owner refs, pod categorization.

Parity targets: ComputeHash over PodTemplateSpecs (reference
internal/utils kubernetes helpers), the grove.io label sets each component
stamps (api/common/labels.go), and pod categorization for status flows
(internal/utils/kubernetes/pod.go:183).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict
from typing import Any

from ..api import constants
from ..api.meta import ObjectMeta, OwnerReference
from ..api.types import Pod, PodCliqueSet, PodPhase


#: identity-keyed memo for stable_hash. The MVCC store shares spec objects
#: across object versions and never mutates stored objects in place, so
#: hashing the same (peeked) spec object repeatedly is the common case at
#: control-plane scale. Entries hold a strong reference to the keyed object
#: so its id() cannot be recycled while the entry lives; the cache is
#: cleared when it grows past a bound.
_HASH_MEMO: dict[int, tuple[Any, str]] = {}


def stable_hash(obj: Any, memo: bool = True) -> str:
    """Deterministic short hash of a dataclass/dict tree (FNV-of-SpecHash
    equivalent of the reference's ComputeHash). NOTE: memoized by object
    identity — do not mutate an object between stable_hash calls and
    expect a fresh hash; hash a fresh clone instead (store reads already
    behave this way). Pass memo=False when hashing a freshly-cloned object
    (e.g. a get() result): its id never recurs, so caching it only pins
    garbage and churns the hot entries out."""
    is_dc = hasattr(obj, "__dataclass_fields__")
    cacheable = memo and is_dc
    if cacheable:
        key = id(obj)
        hit = _HASH_MEMO.get(key)
        if hit is not None and hit[0] is obj:
            return hit[1]
    data = asdict(obj) if is_dc else obj
    payload = json.dumps(data, sort_keys=True, default=str)
    digest = hashlib.sha1(payload.encode()).hexdigest()[:10]
    # plain dicts (e.g. pcs_generation_hash's per-call aggregate) are built
    # fresh every call — caching them would only pin garbage
    if cacheable:
        if len(_HASH_MEMO) > 8192:
            _HASH_MEMO.clear()
        _HASH_MEMO[key] = (obj, digest)
    return digest


def pcs_generation_hash(pcs: PodCliqueSet) -> str:
    """Hash of all clique pod templates — a change starts a rolling update
    (reference reconcilespec.go:109-122)."""
    return stable_hash(
        {c.name: asdict(c.spec.pod_spec) for c in pcs.spec.template.cliques}
    )


def owner_ref(obj: Any) -> OwnerReference:
    return OwnerReference(
        kind=obj.KIND, name=obj.metadata.name, uid=obj.metadata.uid
    )


def base_labels(pcs_name: str) -> dict[str, str]:
    return {
        constants.LABEL_MANAGED_BY: constants.LABEL_MANAGED_BY_VALUE,
        constants.LABEL_PART_OF: pcs_name,
    }


def is_pod_active(pod: Pod) -> bool:
    return (
        pod.metadata.deletion_timestamp is None
        and pod.status.phase not in (PodPhase.SUCCEEDED, PodPhase.FAILED)
    )


def is_pod_healthy(pod: Pod) -> bool:
    """Counts toward MinAvailable: ready, or started and never crashed
    (reference podclique/reconcilestatus.go:176-225)."""
    if not is_pod_active(pod):
        return False
    if pod.status.ready:
        return True
    return (
        pod.status.phase == PodPhase.RUNNING
        and pod.status.ever_started
        and pod.status.restart_count == 0
    )


def new_meta(
    name: str,
    namespace: str,
    owner: Any,
    labels: dict[str, str],
    annotations: dict[str, str] | None = None,
) -> ObjectMeta:
    return ObjectMeta(
        name=name,
        namespace=namespace,
        labels=dict(labels),
        annotations=dict(annotations or {}),
        owner_references=[owner_ref(owner)],
    )
