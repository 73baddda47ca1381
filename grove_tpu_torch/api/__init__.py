"""Workload + scheduler-contract API surface of grove_tpu_torch.

The counterpart of grove_tpu/api/__init__.py. It exports the same names
and adds `NodeStatus`."""

from . import constants, naming
from .defaulting import default_podcliqueset, default_podgang
from .meta import (
    Condition,
    NamespacedName,
    ObjectMeta,
    OwnerReference,
    get_condition,
    new_uid,
    set_condition,
)
from .podgang import (
    PodGang,
    PodGangConditionType,
    PodGangPhase,
    PodGangSpec,
    PodGangStatus,
    PodGroup,
    TopologyConstraint,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from .types import (
    CLUSTER_TOPOLOGY_NAME,
    MAX_TOPOLOGY_LEVELS,
    TOPOLOGY_DOMAIN_ORDER,
    AutoScalingConfig,
    CliqueStartupType,
    ClusterTopology,
    ClusterTopologySpec,
    Container,
    HeadlessServiceConfig,
    LastError,
    LastOperation,
    Node,
    NodeStatus,
    PCSGRollingUpdateProgress,
    PCSRollingUpdateProgress,
    Pod,
    PodClique,
    PodCliqueRollingUpdateProgress,
    PodCliqueScalingGroup,
    PodCliqueScalingGroupConfig,
    PodCliqueScalingGroupSpec,
    PodCliqueScalingGroupStatus,
    PodCliqueSet,
    PodCliqueSetSpec,
    PodCliqueSetStatus,
    PodCliqueSetTemplateSpec,
    PodCliqueSpec,
    PodCliqueStatus,
    PodCliqueTemplateSpec,
    PodPhase,
    PodSpec,
    PodStatus,
    TopologyConstraintSpec,
    TopologyLevel,
    TopologyPackConstraintSpec,
    sort_topology_levels,
)
from .validation import (
    ValidationError,
    find_cycles,
    validate_cluster_topology,
    validate_hpa,
    validate_podcliqueset,
    validate_podcliqueset_update,
    validate_podgang,
)
from .config import (
    AuthorizationConfig,
    AutoscalerConfig,
    ControllerConfig,
    LogConfig,
    OperatorConfig,
    ServingConfig,
    SolverConfig,
    TenancyConfig,
    TopologyAwareSchedulingConfig,
    WorkloadDefaultsConfig,
    load_operator_config,
    validate_operator_config,
)

__all__ = [name for name in dir() if not name.startswith("_")]
