"""Scheduler contract: the PodGang API group.

The counterpart of grove_tpu/api/podgang.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Mirror of scheduler/api/core/v1alpha1/podgang.go — the
contract between the operator and the gang placement engine. In the reference
this is consumed by the external KAI scheduler; here it is consumed by
grove_tpu.solver (the TPU placement engine), which is the framework's
genuinely new component.

Kept in its own module to mirror the reference's separate scheduler.grove.io
API group.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from .meta import Condition, NamespacedName, ObjectMeta


@dataclass(slots=True)
class TopologyPackConstraint:
    """Pack constraint by node-label *key* (podgang.go:102-118).

    required: hard — the member pods must land within one domain at this
    level or the gang does not schedule.
    preferred: soft — the solver adds a cost penalty for splitting across
    domains at this level but may fall back up to `required`.
    """

    required: Optional[str] = None
    preferred: Optional[str] = None


@dataclass(slots=True)
class TopologyConstraint:
    pack_constraint: Optional[TopologyPackConstraint] = None


@dataclass(slots=True)
class PodGroup:
    """A set of pods sharing one PodTemplateSpec (podgang.go:76-90)."""

    name: str
    pod_references: list[NamespacedName] = field(default_factory=list)
    # Gang threshold: scheduler guarantees all-or-nothing for min_replicas;
    # pods beyond that are best-effort.
    min_replicas: int = 1
    topology_constraint: Optional[TopologyConstraint] = None


@dataclass(slots=True)
class TopologyConstraintGroupConfig:
    """Constraint over a strict subset of PodGroups (podgang.go:121-132) —
    used to express PCSG co-location inside a base PodGang."""

    name: str
    pod_group_names: list[str] = field(default_factory=list)
    topology_constraint: Optional[TopologyConstraint] = None


@dataclass(slots=True)
class PodGangSpec:
    """podgang.go:51-73."""

    pod_groups: list[PodGroup] = field(default_factory=list)
    topology_constraint: Optional[TopologyConstraint] = None
    topology_constraint_group_configs: list[TopologyConstraintGroupConfig] = field(
        default_factory=list
    )
    priority_class_name: str = ""
    # Placement-reuse hint for rolling updates (podgang.go:66-72): suggest
    # the solver reuse the reservation of a previous PodGang.
    reuse_reservation_ref: Optional[NamespacedName] = None


class PodGangPhase(str, enum.Enum):
    """podgang.go:147-155."""

    PENDING = "Pending"
    STARTING = "Starting"
    RUNNING = "Running"


class PodGangConditionType(str, enum.Enum):
    """podgang.go:158-169."""

    SCHEDULED = "Scheduled"
    READY = "Ready"
    UNHEALTHY = "Unhealthy"
    DISRUPTION_TARGET = "DisruptionTarget"


@dataclass(slots=True)
class PodGangStatus:
    """podgang.go:171-181."""

    phase: PodGangPhase = PodGangPhase.PENDING
    conditions: list[Condition] = field(default_factory=list)
    # Network-optimality score in (0, 1]; 1.0 = best possible placement
    # (podgang.go:177-179). Written by the solver from its objective value.
    placement_score: Optional[float] = None


@dataclass(slots=True)
class PodGang:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGangSpec = field(default_factory=PodGangSpec)
    status: PodGangStatus = field(default_factory=PodGangStatus)

    KIND = "PodGang"
