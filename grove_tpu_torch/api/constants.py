"""Labels, annotations, env vars, condition types, defaults.

The counterpart of grove_tpu/api/constants.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Parity with operator/api/common/{labels.go,constants/constants.go}.
Values keep the grove.io/* names so workloads written against the reference
read identically here.
"""

# --- Labels (labels.go:20-46) ---
LABEL_APP_NAME = "app.kubernetes.io/name"
LABEL_MANAGED_BY = "app.kubernetes.io/managed-by"
LABEL_PART_OF = "app.kubernetes.io/part-of"
LABEL_COMPONENT = "app.kubernetes.io/component"
LABEL_MANAGED_BY_VALUE = "grove-operator"

LABEL_PODCLIQUE = "grove.io/podclique"
LABEL_PODGANG = "grove.io/podgang"
LABEL_BASE_PODGANG = "grove.io/base-podgang"
LABEL_PCS_REPLICA_INDEX = "grove.io/podcliqueset-replica-index"
LABEL_PCSG = "grove.io/podcliquescalinggroup"
LABEL_PCSG_REPLICA_INDEX = "grove.io/podcliquescalinggroup-replica-index"
LABEL_POD_TEMPLATE_HASH = "grove.io/pod-template-hash"
LABEL_POD_INDEX = "grove.io/pod-index"
# Which PCS clique template a PodClique instantiates. Needed because clique
# names may themselves contain hyphens, so the template name cannot be
# recovered from the PodClique FQN by splitting.
LABEL_CLIQUE_TEMPLATE = "grove.io/clique-template-name"
# Owning tenant for multi-tenant scheduling (grove_tpu/tenancy): stamped
# on a PodCliqueSet by the user and propagated onto its PodGangs; gangs
# without it attribute by namespace == tenant name. The default value of
# api.config.TenancyConfig.tenant_label.
LABEL_TENANT = "grove.io/tenant"

# Component values for LABEL_COMPONENT.
COMPONENT_HEADLESS_SERVICE = "pcs-headless-service"
COMPONENT_PCSG = "pcs-podcliquescalinggroup"
COMPONENT_HPA = "pcs-hpa"
COMPONENT_PODGANG = "podgang"
COMPONENT_PCS_PODCLIQUE = "pcs-podclique"
COMPONENT_PCSG_PODCLIQUE = "pcsg-podclique"

# --- Annotations (constants.go:42-48) ---
ANNOTATION_DISABLE_MANAGED_RESOURCE_PROTECTION = (
    "grove.io/disable-managed-resource-protection"
)
ANNOTATION_TOPOLOGY_NAME = "grove.io/topology-name"
# Startup-order barrier spec, '<pclqFQN>:<minAvailable>,...' — carries the
# same dependency list the reference passes to the grove-initc init
# container as --podcliques args (pod/initcontainer.go:155); consumed by the
# simulated kubelet instead of an in-pod binary.
ANNOTATION_WAIT_FOR = "grove.io/wait-for"
# Stamped by Cluster.drain (alongside the cordon) to mark a node under
# gang-aware graceful drain; the NodeMonitor paces the evictions and
# Cluster.uncordon clears it (the kubectl-drain / maintenance analog).
ANNOTATION_DRAIN = "grove.io/drain"

# --- Scheduling gate (components/pod/pod.go:68) ---
PODGANG_PENDING_CREATION_GATE = "grove.io/podgang-pending-creation"

# --- Env vars injected into workload pods (constants.go:50-68) ---
ENV_PCS_NAME = "GROVE_PCS_NAME"
ENV_PCS_INDEX = "GROVE_PCS_INDEX"
ENV_PCLQ_NAME = "GROVE_PCLQ_NAME"
ENV_HEADLESS_SERVICE = "GROVE_HEADLESS_SERVICE"
ENV_PCLQ_POD_INDEX = "GROVE_PCLQ_POD_INDEX"
ENV_PCSG_NAME = "GROVE_PCSG_NAME"
ENV_PCSG_INDEX = "GROVE_PCSG_INDEX"
ENV_PCSG_TEMPLATE_NUM_PODS = "GROVE_PCSG_TEMPLATE_NUM_PODS"

# --- Condition types (constants.go:86-95) ---
CONDITION_MIN_AVAILABLE_BREACHED = "MinAvailableBreached"
CONDITION_PODCLIQUE_SCHEDULED = "PodCliqueScheduled"
CONDITION_TOPOLOGY_LEVELS_UNAVAILABLE = "TopologyLevelsUnavailable"

# --- Condition reasons ---
REASON_INSUFFICIENT_READY_PODS = "InsufficientReadyPods"
REASON_SUFFICIENT_READY_PODS = "SufficientReadyPods"
REASON_INSUFFICIENT_SCHEDULED_PODS = "InsufficientScheduledPods"
REASON_SUFFICIENT_SCHEDULED_PODS = "SufficientScheduledPods"

# --- Finalizers ---
FINALIZER_PCS = "grove.io/podcliqueset-protection"
FINALIZER_PCLQ = "grove.io/podclique-protection"
FINALIZER_PCSG = "grove.io/podcliquescalinggroup-protection"

# --- Defaults (webhook/admission/pcs/defaulting/podcliqueset.go:30-117) ---
DEFAULT_TERMINATION_DELAY_SECONDS = 4 * 60 * 60  # 4h
DEFAULT_REPLICAS = 1

# --- Reconcile tuning (internal/constants/constants.go:31) ---
COMPONENT_SYNC_RETRY_INTERVAL_SECONDS = 5.0

# --- Validation budgets (validation/podcliqueset.go:37) ---
MAX_COMBINED_NAME_LENGTH = 45
# Pod names double as hostnames, so the WORST-CASE generated name
# ('<pcs>-<i>-[<sg>-<j>-]<clique>-<k>' with real replica-digit widths) must
# fit a DNS-1123 label. The reference only budgets the 45-char component sum
# and reserves a fixed 8/10 chars for indices; counting the generated name
# exactly closes the gap where huge replica counts overflow the reserve.
MAX_GENERATED_NAME_LENGTH = 63

#: The gang scheduler's own name: pods with an empty schedulerName or this
#: one are grove_tpu's to place; any other name routes to an external
#: scheduler (the reference routes schedulerName=kai-scheduler pods to KAI
#: the same way — single-name rule enforced by validation).
SCHEDULER_NAME = "grove-tpu-scheduler"
