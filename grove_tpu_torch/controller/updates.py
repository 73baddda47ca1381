"""Rolling-update helpers shared by the PCS and PCSG reconcilers.

Semantics from the reference (podcliquesetreplica/rollingupdate.go:40-73,
196-250 and pcsg components/podclique/rollingupdate.go): one PCS replica at
a time, chosen by (no scheduled pods -> breached -> lowest ordinal); within
a PCS replica, each PCSG rolls one of ITS replicas at a time; within a
PodClique, pods replace one ready pod at a time (podclique controller).
Completion is detected by hash propagation: a clique is updated once its
spec carries the target template AND every active pod carries the matching
pod-template-hash label and at least minAvailable are ready again.
"""

from __future__ import annotations

from ..api import constants
from ..api.meta import get_condition
from ..api.types import Pod, PodClique, PodCliqueSet
from ..cluster.store import ObjectStore
from .common import is_pod_active, stable_hash


def clique_template_hashes(pcs: PodCliqueSet) -> dict[str, str]:
    """clique template name -> target pod-template hash. memo=False: the
    reconcilers pass a get()-cloned PCS, whose template objects are fresh
    every call — caching them would only pollute the identity memo."""
    return {
        c.name: stable_hash(c.spec.pod_spec, memo=False)
        for c in pcs.spec.template.cliques
    }


def clique_updated(store: ObjectStore, pclq: PodClique, target_hash: str) -> bool:
    """Spec propagated AND all pods rolled AND availability restored."""
    if stable_hash(pclq.spec.pod_spec) != target_hash:
        return False
    pods = [
        p
        for p in store.list(
            Pod.KIND,
            namespace=pclq.metadata.namespace,
            labels={constants.LABEL_PODCLIQUE: pclq.metadata.name},
        )
        if is_pod_active(p)
    ]
    if len(pods) < pclq.spec.replicas:
        return False
    if any(
        p.metadata.labels.get(constants.LABEL_POD_TEMPLATE_HASH) != target_hash
        for p in pods
    ):
        return False
    min_avail = pclq.spec.min_available or pclq.spec.replicas
    return sum(1 for p in pods if p.status.ready) >= min_avail


def prune_vanished_replicas(prog, replicas: int) -> None:
    """Scale-in x update race bookkeeping (RU12/RU16, reference
    rolling_updates_test.go): a replica index >= the shrunk spec.replicas
    can never report updated — its cliques are deleted. Drop the in-flight
    pointer (else the rollout wedges waiting on a ghost) and prune stale
    updated indices (else status.updated_replicas exceeds spec.replicas
    forever once the update completes). Shared by the PCS and PCSG
    rolling-update orchestrators."""
    if (
        prog.current_replica_index is not None
        and prog.current_replica_index >= replicas
    ):
        prog.current_replica_index = None
    prog.updated_replica_indices = [
        i for i in prog.updated_replica_indices if i < replicas
    ]


def pick_next_replica(
    store: ObjectStore, pcs: PodCliqueSet, remaining: list[int]
) -> int:
    """Replica order (rollingupdate.go:196-250): replicas with no scheduled
    pods first (free win — nothing running to disturb), then breached ones,
    then lowest ordinal."""
    ns, name = pcs.metadata.namespace, pcs.metadata.name

    def key(i: int) -> tuple:
        sel = {
            constants.LABEL_PART_OF: name,
            constants.LABEL_PCS_REPLICA_INDEX: str(i),
        }
        pods = store.list(Pod.KIND, namespace=ns, labels=sel)
        scheduled = sum(1 for p in pods if p.node_name)
        breached = False
        for pclq in store.list(PodClique.KIND, namespace=ns, labels=sel):
            cond = get_condition(
                pclq.status.conditions, constants.CONDITION_MIN_AVAILABLE_BREACHED
            )
            if cond is not None and cond.status == "True":
                breached = True
        return (0 if scheduled == 0 else 1, 0 if breached else 1, i)

    return min(remaining, key=key)
