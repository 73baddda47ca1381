"""Admission validation the placement solve relies on.

The counterpart of grove_tpu/api/validation.py, trimmed to
`validate_cluster_topology`: `encode_topology` calls it on entry, so
every snapshot downstream works on a well-formed hierarchy.
"""

from __future__ import annotations

from .types import MAX_TOPOLOGY_LEVELS, TOPOLOGY_DOMAIN_ORDER


class ValidationError(ValueError):
    """Aggregated admission failure."""

    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def validate_cluster_topology(ct) -> None:
    """Admission-time validation for ClusterTopology (the reference enforces
    the domain enum via CRD schema, clustertopology.go:72-87). Unknown
    domains are rejected here, not deep in the solve path."""
    errs: list[str] = []
    seen_domains: set[str] = set()
    seen_keys: set[str] = set()
    for i, lv in enumerate(ct.spec.levels):
        path = f"spec.levels[{i}]"
        if lv.domain not in TOPOLOGY_DOMAIN_ORDER:
            errs.append(
                f"{path}.domain: unknown topology domain {lv.domain!r} "
                f"(supported: {sorted(TOPOLOGY_DOMAIN_ORDER)})"
            )
        if lv.domain in seen_domains:
            errs.append(f"{path}.domain: duplicate domain {lv.domain!r}")
        seen_domains.add(lv.domain)
        if not lv.key:
            errs.append(f"{path}.key: node label key must not be empty")
        if lv.key in seen_keys:
            errs.append(f"{path}.key: duplicate label key {lv.key!r}")
        seen_keys.add(lv.key)
    if len(ct.spec.levels) > MAX_TOPOLOGY_LEVELS:
        errs.append(f"spec.levels: at most {MAX_TOPOLOGY_LEVELS} levels")
    if errs:
        raise ValidationError(errs)
