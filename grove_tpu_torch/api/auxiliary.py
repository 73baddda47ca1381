"""Auxiliary managed kinds: Service, RBAC trio, token Secret, HPA.

The counterpart of grove_tpu/api/auxiliary.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

The reference creates these as real Kubernetes objects
(operator/internal/controller/podcliqueset/components/{service,
serviceaccount,role,rolebinding,satokensecret,hpa}/). Here they are
lightweight store objects: the headless Service carries the DNS contract
(selector + publishNotReadyAddresses), the RBAC trio + token secret model
the per-PCS identity the reference provisions for its init containers, and
the HorizontalPodAutoscaler is consumed by the in-process autoscaler loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta


@dataclass(slots=True)
class Service:
    """Headless service per PCS replica (components/service/service.go:119-204)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict[str, str] = field(default_factory=dict)
    cluster_ip: str = "None"  # headless
    publish_not_ready_addresses: bool = True

    KIND = "Service"


@dataclass(slots=True)
class ServiceAccount:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND = "ServiceAccount"


@dataclass(slots=True)
class Role:
    """Pods list/watch only (components/role/)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: list[str] = field(default_factory=lambda: ["pods:list", "pods:watch"])

    KIND = "Role"


@dataclass(slots=True)
class RoleBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    role_name: str = ""
    service_account_name: str = ""

    KIND = "RoleBinding"


@dataclass(slots=True)
class Secret:
    """Service-account token secret for the startup-barrier watcher
    (components/satokensecret/)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "kubernetes.io/service-account-token"
    service_account_name: str = ""

    KIND = "Secret"


@dataclass(slots=True)
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass equivalent. PodGang's
    PriorityClassName (podgang.go:62-64) is an opaque reference to one of
    these objects — NOT a naming convention; the scheduler resolves it to
    `value` for backlog ordering and contention."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: float = 0.0
    global_default: bool = False
    description: str = ""

    KIND = "PriorityClass"


@dataclass(slots=True)
class HPASpec:
    target_kind: str = ""     # PodClique | PodCliqueScalingGroup
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 1
    target_resource: str = "cpu"
    target_utilization: float = 0.8


@dataclass(slots=True)
class HPAStatus:
    current_replicas: int = 0
    desired_replicas: int = 0
    last_scale_time: float = 0.0


@dataclass(slots=True)
class HorizontalPodAutoscaler:
    """autoscaling/v2 HPA equivalent (components/hpa/hpa.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HPASpec = field(default_factory=HPASpec)
    status: HPAStatus = field(default_factory=HPAStatus)

    KIND = "HorizontalPodAutoscaler"
