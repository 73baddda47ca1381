"""Object metadata, conditions and common machinery for grove_tpu API objects.

The counterpart of grove_tpu/api/meta.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Plays the role of k8s apimachinery ObjectMeta/metav1.Condition in the
reference (used throughout operator/api/core/v1alpha1/).
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

# Monotonic clock for the simulated control plane. Tests can freeze/advance it
# via cluster.clock; API objects only record floats (seconds).
_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass(slots=True)
class OwnerReference:
    """Reference from a child object to its controlling owner."""

    kind: str
    name: str
    uid: str = ""
    controller: bool = True


@dataclass(slots=True)
class ObjectMeta:
    """Subset of k8s ObjectMeta the framework needs.

    generation increments on every spec mutation (handled by the store);
    resource_version increments on any write.
    """

    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    generation: int = 1
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[OwnerReference] = field(default_factory=list)


@dataclass(slots=True)
class Condition:
    """Mirror of metav1.Condition semantics."""

    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass(frozen=True)
class NamespacedName:
    """scheduler/api/core/v1alpha1/podgang.go:138-144 equivalent."""

    namespace: str
    name: str

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.namespace}/{self.name}"


def get_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def set_condition(
    conditions: list[Condition],
    ctype: str,
    status: str,
    reason: str = "",
    message: str = "",
    now: float = 0.0,
) -> bool:
    """Upsert a condition; last_transition_time only moves on status flips.

    Returns True when the condition's status actually changed (used by watch
    predicates, mirroring the reference's condition-flip predicates in
    operator/internal/controller/podcliqueset/register.go:146-157).
    """
    existing = get_condition(conditions, ctype)
    if existing is None:
        conditions.append(
            Condition(type=ctype, status=status, reason=reason, message=message,
                      last_transition_time=now)
        )
        return True
    changed = existing.status != status
    if changed:
        existing.last_transition_time = now
    existing.status = status
    existing.reason = reason
    existing.message = message
    return changed


def deepcopy_obj(obj: Any) -> Any:
    """Deep copy an API dataclass (store never hands out shared references)."""
    import copy

    return copy.deepcopy(obj)


def asdict(obj: Any) -> dict:
    return dataclasses.asdict(obj)
