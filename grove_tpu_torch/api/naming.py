"""Deterministic resource naming scheme.

The counterpart of grove_tpu/api/naming.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Parity with operator/api/common/namegen.go:70-115. The
naming grammar is load-bearing: gate-removal logic and the solver locate
objects purely by these names and labels.

  PodClique (standalone):    <pcs>-<pcsReplica>-<cliqueName>
  PCSG (fully qualified):    <pcs>-<pcsReplica>-<sgName>
  PodClique (inside PCSG):   <pcsgFQN>-<pcsgReplica>-<cliqueName>
  base PodGang:              <pcs>-<pcsReplica>
  scaled PodGang:            <pcsgFQN>-<scaledIndex>    (0-based beyond minAvailable)
  Pod hostname:              <pclq>-<podIndex>
  Headless service:          <pcs>-<pcsReplica>
"""

from __future__ import annotations


def podclique_name(owner_name: str, owner_replica: int, clique_template_name: str) -> str:
    """namegen.go:72-75 (also used for PCSG-owned cliques with the PCSG FQN
    as owner, pcsg/components/podclique/podclique.go)."""
    return f"{owner_name}-{owner_replica}-{clique_template_name}"


def pcsg_name(pcs_name: str, pcs_replica: int, scaling_group_name: str) -> str:
    """namegen.go:78-81."""
    return f"{pcs_name}-{pcs_replica}-{scaling_group_name}"


def base_podgang_name(pcs_name: str, pcs_replica: int) -> str:
    """namegen.go:84-87."""
    return f"{pcs_name}-{pcs_replica}"


def scaled_podgang_name(pcsg_fqn: str, scaled_index: int) -> str:
    """namegen.go:90-93 (CreatePodGangNameFromPCSGFQN)."""
    return f"{pcsg_fqn}-{scaled_index}"


def podgang_name_for_pcsg_replica(
    pcs_name: str, pcs_replica: int, pcsg_fqn: str, pcsg_replica: int, min_available: int
) -> str:
    """Replica [0, minAvailable) -> base gang; beyond -> scaled gang with
    0-based index (namegen.go:100-115)."""
    if pcsg_replica < min_available:
        return base_podgang_name(pcs_name, pcs_replica)
    return scaled_podgang_name(pcsg_fqn, pcsg_replica - min_available)


def headless_service_name(pcs_name: str, pcs_replica: int) -> str:
    """namegen.go:34-36."""
    return f"{pcs_name}-{pcs_replica}"


def headless_service_address(pcs_name: str, pcs_replica: int, namespace: str) -> str:
    """namegen.go:39-42."""
    return f"{headless_service_name(pcs_name, pcs_replica)}.{namespace}.svc.cluster.local"


def pod_name(pclq_name: str, pod_index: int) -> str:
    """Stable hole-filling pod identity: hostname <pclq>-<idx>
    (components/pod/pod.go:257-264, index/tracker.go)."""
    return f"{pclq_name}-{pod_index}"


def hpa_name(target_name: str) -> str:
    return f"{target_name}-hpa"


def parse_pcs_replica_from_pclq(pclq_name: str, pcs_name: str) -> int:
    """Extract the PCS replica index from a standalone PodClique name."""
    rest = pclq_name[len(pcs_name) + 1 :]
    return int(rest.split("-", 1)[0])
