"""Managed-resource authorization policy.

Parity with the reference's authorization webhook
(operator/internal/webhook/admission/pcs/authorization/): only the
operator's own identity (plus a configured exempt list) may mutate
Grove-MANAGED resources — the children the operator stamps with
`app.kubernetes.io/managed-by: grove-operator` (PodCliques, PCSGs, Pods,
PodGangs, Services, ...). User-owned objects (the PodCliqueSets users
apply) are not gated: users own what they created; the protection exists
so nobody strips finalizers or rewrites specs out from under the
reconcilers. The `grove.io/disable-managed-resource-protection` annotation
opts a single object out, mirroring the reference's escape hatch
(constants.go:42-48).
"""

from __future__ import annotations

from typing import Any, Callable

from . import constants
from .config import AuthorizationConfig
from .types import Pod, PodCliqueSet

#: Identities authorized regardless of config (apiserver-internal agents).
SYSTEM_ACTORS = frozenset({"system:garbage-collector"})


def make_authorizer(
    cfg: AuthorizationConfig, store: Any = None
) -> Callable[[str, str, Any], None]:
    """Build the store's authorize(actor, verb, obj) hook. Raises
    cluster.store.Forbidden on a denied mutation.

    Parity details (reference handler.go:121-135): Pod DELETE is exempt for
    every actor — pod eviction/drain by cluster agents must never be blocked
    by workload protection. The disable-protection annotation is honored
    both on the object itself AND on its owning PodCliqueSet (resolved via
    the part-of label when a store is provided), so opting out a whole PCS
    tree takes one annotation, not one per child."""
    from ..cluster.store import Forbidden

    allowed = SYSTEM_ACTORS | {cfg.operator_identity, *cfg.exempt_actors}
    disable = constants.ANNOTATION_DISABLE_MANAGED_RESOURCE_PROTECTION

    def authorize(actor: str, verb: str, obj: Any) -> None:
        labels = obj.metadata.labels
        if labels.get(constants.LABEL_MANAGED_BY) != constants.LABEL_MANAGED_BY_VALUE:
            return  # not a Grove-managed resource
        if actor in allowed:
            return  # hot path: the operator's own writes exit here
        if verb == "delete" and obj.KIND == Pod.KIND:
            return  # handler.go:121-135: pod deletion is always permitted
        if obj.metadata.annotations.get(disable) == "true":
            return
        if store is not None:
            owner = labels.get(constants.LABEL_PART_OF)
            if owner and obj.KIND != PodCliqueSet.KIND:
                pcs = store.peek(PodCliqueSet.KIND, obj.metadata.namespace, owner)
                if (
                    pcs is not None
                    and pcs.metadata.annotations.get(disable) == "true"
                ):
                    return
        raise Forbidden(
            f"actor {actor!r} may not {verb} Grove-managed {obj.KIND} "
            f"{obj.metadata.namespace}/{obj.metadata.name} "
            f"(managed resources are mutable only by the operator identity "
            f"{cfg.operator_identity!r} or exempt actors)"
        )

    return authorize
