"""Defaulting for PodCliqueSet (admission-webhook parity).

The counterpart of grove_tpu/api/defaulting.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Mirror of operator/internal/webhook/admission/pcs/defaulting/
podcliqueset.go:30-117: replicas->1, MinAvailable->Replicas,
TerminationDelay->4h, headless publishNotReadyAddresses->true, PCSG
replicas/minAvailable->1, startupType->AnyOrder. Unlike the reference's HPA
minReplicas coercion, an invalid scaleConfig.minReplicas < 1 is left for
validation to reject (defaulting only fills unset fields).
"""

from __future__ import annotations

from . import constants
from .types import (
    CliqueStartupType,
    HeadlessServiceConfig,
    PodCliqueSet,
)


def default_podcliqueset(pcs: PodCliqueSet, defaults=None) -> PodCliqueSet:
    """Apply defaults in place and return pcs.

    defaults: an api.config.WorkloadDefaultsConfig; None uses the built-in
    constants (the reference's defaulting webhook reads the same values from
    its OperatorConfiguration)."""
    default_replicas = defaults.replicas if defaults else constants.DEFAULT_REPLICAS
    default_delay = (
        defaults.termination_delay_seconds
        if defaults
        else float(constants.DEFAULT_TERMINATION_DELAY_SECONDS)
    )
    if pcs.metadata.namespace == "":
        pcs.metadata.namespace = "default"
    if pcs.spec.replicas is None or pcs.spec.replicas == 0:
        pcs.spec.replicas = default_replicas

    tmpl = pcs.spec.template
    if tmpl.startup_type is None:
        tmpl.startup_type = CliqueStartupType.ANY_ORDER
    if tmpl.termination_delay is None:
        tmpl.termination_delay = float(default_delay)
    if tmpl.head_less_service_config is None:
        tmpl.head_less_service_config = HeadlessServiceConfig(
            publish_not_ready_addresses=True
        )

    for clique in tmpl.cliques:
        cspec = clique.spec
        if cspec.role_name == "":
            cspec.role_name = clique.name
        if cspec.replicas is None or cspec.replicas == 0:
            cspec.replicas = 1
        if cspec.min_available is None:
            cspec.min_available = cspec.replicas

    for sg in tmpl.pod_clique_scaling_group_configs:
        if sg.replicas is None:
            sg.replicas = 1
        if sg.min_available is None:
            sg.min_available = 1

    return pcs


def default_podgang(pg, tier_of=None, default_tier: str = ""):
    """PodGang defaulting (registered by Cluster when tenancy is
    enabled): an EMPTY spec.priority_class_name — which previously
    round-tripped silently and resolved to the global-default
    PriorityClass — defaults to the gang's tenant tier (`tier_of(pg)`,
    the TenancyManager hook) or the configured default tier, so every
    admitted gang carries an explicit, validated tier. Set fields are
    never touched (defaulting only fills unset fields)."""
    if not pg.spec.priority_class_name:
        tier = tier_of(pg) if tier_of is not None else ""
        pg.spec.priority_class_name = tier or default_tier
    return pg
