"""Validation for PodCliqueSet (admission-webhook parity).

The counterpart of grove_tpu/api/validation.py, copied whole. It imports
nothing of grove_tpu, so the two packages' objects compare field by
field.

Mirror of operator/internal/webhook/admission/pcs/validation/
{podcliqueset.go,podcliquedeps.go}: DNS names, 45-char combined-name budget,
unique clique names/roles, single scheduler name, startsAfter DAG existence +
cycle detection via Tarjan SCC, PCSG constraints, terminationDelay > 0, and
PCS >= PCSG >= PCLQ topology-constraint strictness
(docs/designs/topology.md:530-541). The SCC algorithm is implemented fresh
(iterative Tarjan) — the reference uses its own SCC pass for the same purpose
(validation/podcliqueset.go:278-300).
"""

from __future__ import annotations

import re

from . import constants
from .types import (
    MAX_TOPOLOGY_LEVELS,
    TOPOLOGY_DOMAIN_ORDER,
    CliqueStartupType,
    PodCliqueSet,
    TopologyConstraintSpec,
)


class ValidationError(ValueError):
    """Aggregated admission failure."""

    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def _is_dns_label(name: str) -> bool:
    return bool(name) and len(name) <= 63 and _DNS1123.match(name) is not None


def _index_digits(count: int) -> int:
    """Decimal width of the largest index generated for `count` replicas."""
    return len(str(max(count - 1, 0)))


def _pack_level(tc: TopologyConstraintSpec | None) -> int | None:
    """Narrowest meaningful level index of a constraint (required wins)."""
    if tc is None or tc.pack_constraint is None:
        return None
    pc = tc.pack_constraint
    dom = pc.required if pc.required is not None else pc.preferred
    if dom is None:
        return None
    return TOPOLOGY_DOMAIN_ORDER.get(dom)


def _validate_topology_constraint(
    tc: TopologyConstraintSpec | None, path: str, errs: list[str]
) -> None:
    if tc is None or tc.pack_constraint is None:
        return
    for fieldname in ("required", "preferred"):
        dom = getattr(tc.pack_constraint, fieldname)
        if dom is not None and dom not in TOPOLOGY_DOMAIN_ORDER:
            errs.append(
                f"{path}.packConstraint.{fieldname}: unknown topology domain "
                f"{dom!r} (supported: {sorted(TOPOLOGY_DOMAIN_ORDER)})"
            )


def find_cycles(edges: dict[str, list[str]]) -> list[list[str]]:
    """Strongly connected components of size > 1 (or self-loops) in the
    startsAfter graph — iterative Tarjan to stay recursion-safe on deep DAGs.
    """
    index: dict[str, int] = {}
    lowlink: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    cycles: list[list[str]] = []

    for root in edges:
        if root in index:
            continue
        work = [(root, iter(edges.get(root, ())))]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in edges:
                    continue  # missing targets reported separately
                if w not in index:
                    index[w] = lowlink[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in edges.get(v, ()):
                    cycles.append(sorted(comp))
    return cycles


def validate_podcliqueset(pcs: PodCliqueSet) -> None:
    """Raise ValidationError on any admission failure (post-defaulting)."""
    errs: list[str] = []
    tmpl = pcs.spec.template

    if not _is_dns_label(pcs.metadata.name):
        errs.append(f"metadata.name: {pcs.metadata.name!r} is not a DNS-1123 label")
    if pcs.spec.replicas < 1:
        errs.append("spec.replicas must be >= 1")
    if tmpl.termination_delay is not None and tmpl.termination_delay <= 0:
        errs.append("spec.template.terminationDelay must be > 0")
    if not tmpl.cliques:
        errs.append("spec.template.cliques must not be empty")

    # Unique clique names + role names; DNS labels; name budget
    # (validation/podcliqueset.go:37: combined generated-name budget of 45).
    seen_names: set[str] = set()
    seen_roles: set[str] = set()
    scheduler_names: set[str] = set()
    pcsg_member_cliques = {
        cn
        for sg in tmpl.pod_clique_scaling_group_configs
        for cn in sg.clique_names
    }
    for i, clique in enumerate(tmpl.cliques):
        path = f"spec.template.cliques[{i}]"
        if not _is_dns_label(clique.name):
            errs.append(f"{path}.name: {clique.name!r} is not a DNS-1123 label")
        if clique.name in seen_names:
            errs.append(f"{path}.name: duplicate clique name {clique.name!r}")
        seen_names.add(clique.name)
        role = clique.spec.role_name
        if role in seen_roles:
            errs.append(f"{path}.spec.roleName: duplicate role {role!r}")
        seen_roles.add(role)
        # Bare component-length budget, matching the reference's formula
        # (validation/podcliqueset.go:548-562). PCSG-member cliques are
        # budgeted against '<pcs><sg><clique>' in the scaling-group loop
        # instead, never against the standalone form.
        if clique.name not in pcsg_member_cliques:
            combined = len(pcs.metadata.name) + len(clique.name)
            if combined > constants.MAX_COMBINED_NAME_LENGTH:
                errs.append(
                    f"{path}: combined name '<pcs>-<replica>-{clique.name}' exceeds "
                    f"{constants.MAX_COMBINED_NAME_LENGTH} chars"
                )
            # Exact worst-case generated hostname '<pcs>-<i>-<clique>-<k>'
            # with real index widths (incl. HPA max) must fit a DNS label;
            # the reference's fixed 8-char index reserve can under-count.
            max_pods = clique.spec.replicas
            if clique.spec.scale_config is not None:
                max_pods = max(max_pods, clique.spec.scale_config.max_replicas)
            worst = (
                len(pcs.metadata.name) + 1 + _index_digits(pcs.spec.replicas)
                + 1 + len(clique.name) + 1 + _index_digits(max_pods)
            )
            if worst > constants.MAX_GENERATED_NAME_LENGTH:
                errs.append(
                    f"{path}: worst-case generated pod name ({worst} chars) "
                    f"exceeds {constants.MAX_GENERATED_NAME_LENGTH}; shorten "
                    "names or reduce replica counts"
                )
        if clique.spec.replicas < 1:
            errs.append(f"{path}.spec.replicas must be >= 1")
        ma = clique.spec.min_available
        if ma is not None and (ma < 1 or ma > clique.spec.replicas):
            errs.append(f"{path}.spec.minAvailable must be in [1, replicas]")
        sc = clique.spec.scale_config
        if sc is not None:
            if sc.max_replicas < clique.spec.replicas:
                errs.append(f"{path}.spec.scaleConfig.maxReplicas must be >= replicas")
            if sc.min_replicas < 1:
                errs.append(f"{path}.spec.scaleConfig.minReplicas must be >= 1")
            # the HPA built from this config must itself pass admission
            # (validate_hpa); catching the bad bounds here names the
            # template field instead of wedging the component sync
            if sc.min_replicas > sc.max_replicas:
                errs.append(
                    f"{path}.spec.scaleConfig: minReplicas must be <= "
                    "maxReplicas"
                )
            if not (0 < sc.target_utilization <= 1):
                errs.append(
                    f"{path}.spec.scaleConfig.targetUtilization must be in "
                    "(0, 1]"
                )
        # empty means the framework's own scheduler — mixing it with a
        # foreign name would deadlock the gang (half its pods routed
        # elsewhere), so it counts toward the single-name rule
        scheduler_names.add(
            clique.spec.pod_spec.scheduler_name or constants.SCHEDULER_NAME
        )
        _validate_topology_constraint(
            clique.spec.topology_constraint, f"{path}.spec.topologyConstraint", errs
        )

    # Single scheduler across all cliques (validation/podcliqueset.go:133-141).
    if len(scheduler_names) > 1:
        errs.append(
            f"all cliques must use a single scheduler name; found {sorted(scheduler_names)}"
        )

    # startsAfter DAG: Explicit-only, edges exist, no cycles
    # (validation/podcliqueset.go:278-300 + podcliquedeps.go).
    edges = {c.name: list(c.spec.starts_after) for c in tmpl.cliques}
    any_deps = any(edges.values())
    if any_deps and tmpl.startup_type != CliqueStartupType.EXPLICIT:
        errs.append(
            "startsAfter is only allowed with startupType CliqueStartupTypeExplicit"
        )
    for cname, deps in edges.items():
        for d in deps:
            if d != cname and d not in edges:
                errs.append(f"clique {cname!r} startsAfter unknown clique {d!r}")
    # Self-loops surface as single-element cycles here.
    for cycle in find_cycles(edges):
        errs.append(f"startsAfter cycle detected among cliques {cycle}")

    # PCSG constraints (validation/podcliqueset.go:178-242).
    pcs_level = _pack_level(tmpl.topology_constraint)
    _validate_topology_constraint(
        tmpl.topology_constraint, "spec.template.topologyConstraint", errs
    )
    # Topology strictness PCS ⊇ PCLQ for standalone cliques (topology.md:530-541).
    if pcs_level is not None:
        for i, clique in enumerate(tmpl.cliques):
            cl_level = _pack_level(clique.spec.topology_constraint)
            if cl_level is not None and cl_level < pcs_level:
                errs.append(
                    f"spec.template.cliques[{i}].spec.topologyConstraint must be at "
                    "least as narrow as the PodCliqueSet constraint"
                )
    claimed: dict[str, str] = {}
    sg_names: set[str] = set()
    by_name = {c.name: c for c in tmpl.cliques}
    for j, sg in enumerate(tmpl.pod_clique_scaling_group_configs):
        path = f"spec.template.podCliqueScalingGroupConfigs[{j}]"
        if not _is_dns_label(sg.name):
            errs.append(f"{path}.name: {sg.name!r} is not a DNS-1123 label")
        if sg.name in sg_names:
            errs.append(f"{path}.name: duplicate scaling group name {sg.name!r}")
        sg_names.add(sg.name)
        if not sg.clique_names:
            errs.append(f"{path}.cliqueNames must not be empty")
        for cn in sg.clique_names:
            if cn not in seen_names:
                errs.append(f"{path}: unknown clique {cn!r}")
            elif cn in claimed:
                errs.append(
                    f"{path}: clique {cn!r} already claimed by scaling group "
                    f"{claimed[cn]!r} (no cross-group overlap)"
                )
            claimed[cn] = sg.name
        if sg.replicas is not None and sg.replicas < 0:
            errs.append(f"{path}.replicas must be >= 0")
        if (
            sg.min_available is not None
            and sg.replicas is not None
            and not (1 <= sg.min_available <= sg.replicas)
        ):
            errs.append(f"{path}.minAvailable must be in [1, replicas]")
        if sg.scale_config is not None:
            if sg.scale_config.min_replicas < 1:
                errs.append(f"{path}.scaleConfig.minReplicas must be >= 1")
            if sg.scale_config.min_replicas > sg.scale_config.max_replicas:
                errs.append(
                    f"{path}.scaleConfig: minReplicas must be <= maxReplicas"
                )
            if not (0 < sg.scale_config.target_utilization <= 1):
                errs.append(
                    f"{path}.scaleConfig.targetUtilization must be in (0, 1]"
                )
            if sg.replicas is not None and not (
                sg.scale_config.min_replicas <= sg.replicas <= sg.scale_config.max_replicas
            ):
                errs.append(f"{path}: replicas must be within scaleConfig bounds")
        # PCSG pod names are '<pcs>-<i>-<sg>-<j>-<clique>-<k>'; the reference
        # budgets the three name components (validation/podcliqueset.go:548-562).
        max_sg_replicas = sg.replicas or 1
        if sg.scale_config is not None:
            max_sg_replicas = max(max_sg_replicas, sg.scale_config.max_replicas)
        for cn in sg.clique_names:
            combined = len(pcs.metadata.name) + len(sg.name) + len(cn)
            if combined > constants.MAX_COMBINED_NAME_LENGTH:
                errs.append(
                    f"{path}: combined name '<pcs>-<i>-{sg.name}-<j>-{cn}' exceeds "
                    f"{constants.MAX_COMBINED_NAME_LENGTH} chars"
                )
            member = by_name.get(cn)
            worst = (
                len(pcs.metadata.name) + 1 + _index_digits(pcs.spec.replicas)
                + 1 + len(sg.name) + 1 + _index_digits(max_sg_replicas)
                + 1 + len(cn) + 1
                + _index_digits(member.spec.replicas if member else 1)
            )
            if worst > constants.MAX_GENERATED_NAME_LENGTH:
                errs.append(
                    f"{path}: worst-case generated pod name ({worst} chars) "
                    f"exceeds {constants.MAX_GENERATED_NAME_LENGTH}; shorten "
                    "names or reduce replica counts"
                )
        # No per-clique HPA inside a PCSG (the PCSG is the scale unit).
        for cn in sg.clique_names:
            c = by_name.get(cn)
            if c is not None and c.spec.scale_config is not None:
                errs.append(
                    f"{path}: clique {cn!r} has its own scaleConfig; cliques in a "
                    "scaling group scale only via the group"
                )
        # Topology strictness PCS ⊇ PCSG ⊇ PCLQ (topology.md:530-541): a
        # child's pack level must be at least as narrow as its parent's.
        sg_level = _pack_level(sg.topology_constraint)
        _validate_topology_constraint(
            sg.topology_constraint, f"{path}.topologyConstraint", errs
        )
        if pcs_level is not None and sg_level is not None and sg_level < pcs_level:
            errs.append(
                f"{path}.topologyConstraint must be at least as narrow as the "
                "PodCliqueSet constraint"
            )
        for cn in sg.clique_names:
            c = by_name.get(cn)
            if c is None:
                continue
            cl_level = _pack_level(c.spec.topology_constraint)
            parent = sg_level if sg_level is not None else pcs_level
            if parent is not None and cl_level is not None and cl_level < parent:
                errs.append(
                    f"clique {cn!r} topologyConstraint must be at least as narrow "
                    "as its scaling group / set constraint"
                )

    if errs:
        raise ValidationError(errs)


def validate_podgang(pg, allowed_priorities=None) -> None:
    """PodGang admission (registered by Cluster when tenancy is enabled):
    spec.priority_class_name must name a configured tenancy tier or a
    known PriorityClass. Before this, ANY string silently round-tripped
    and resolved to priority 0 at solve time — a typo'd tier demoted a
    workload with no signal anywhere. `allowed_priorities` None (tenancy
    disabled) keeps the legacy round-trip behavior; an empty name is
    legal here because defaulting fills it first."""
    if allowed_priorities is None:
        return
    name = pg.spec.priority_class_name
    if name and name not in allowed_priorities:
        raise ValidationError([
            f"spec.priority_class_name: {name!r} is not a configured "
            f"priority tier or PriorityClass "
            f"(allowed: {sorted(allowed_priorities)})"
        ])


#: HPA scale-target vocabulary: the two kinds carrying a scale
#: subresource (the reference puts scale markers on PCLQ and PCSG;
#: PCS scaling is replica-count on the spec, not an HPA target here)
HPA_TARGET_KINDS = ("PodClique", "PodCliqueScalingGroup")


def validate_hpa(hpa) -> None:
    """HorizontalPodAutoscaler admission (registered unconditionally by
    Cluster). Before this, a min>max HPA was accepted and the controller
    clamped nonsensically (desired pinned wherever the clamp order
    happened to land); now the bad object is rejected at create/update
    with the full error list, like every other admitted kind."""
    errs: list[str] = []
    spec = hpa.spec
    if spec.target_kind not in HPA_TARGET_KINDS:
        errs.append(
            f"spec.target_kind: {spec.target_kind!r} is not a scalable "
            f"kind (allowed: {list(HPA_TARGET_KINDS)})"
        )
    if not spec.target_name:
        errs.append("spec.target_name: must name the scale target")
    if spec.min_replicas < 1:
        errs.append("spec.min_replicas: must be >= 1")
    if spec.min_replicas > spec.max_replicas:
        errs.append(
            f"spec.min_replicas: must be <= max_replicas "
            f"({spec.min_replicas} > {spec.max_replicas})"
        )
    if not (0 < spec.target_utilization <= 1):
        errs.append(
            f"spec.target_utilization: must be in (0, 1], got "
            f"{spec.target_utilization!r}"
        )
    if errs:
        raise ValidationError(errs)


def validate_cluster_topology(ct) -> None:
    """Admission-time validation for ClusterTopology (the reference enforces
    the domain enum via CRD schema, clustertopology.go:72-87). Callers of
    topology.encode_topology are guaranteed pre-validated input; unknown
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


def validate_podcliqueset_update(old: PodCliqueSet, new: PodCliqueSet) -> None:
    """Immutable-field checks on update (validation/podcliqueset.go:520-562).

    Per clique: roleName, minAvailable and startsAfter are immutable. The
    clique name *set* is always immutable; clique *order* is additionally
    frozen only when startup order matters (InOrder/Explicit)."""
    errs: list[str] = []
    old_tmpl, new_tmpl = old.spec.template, new.spec.template
    old_names = [c.name for c in old_tmpl.cliques]
    new_names = [c.name for c in new_tmpl.cliques]
    if sorted(old_names) != sorted(new_names):
        errs.append("spec.template.cliques: clique names are immutable")
    else:
        if (
            old_tmpl.startup_type != CliqueStartupType.ANY_ORDER
            and old_names != new_names
        ):
            errs.append(
                "spec.template.cliques: clique order is immutable when "
                "startupType is InOrder/Explicit"
            )
        # Per-clique immutability is reported alongside any order violation
        # so the user learns every problem in one admission round.
        old_by_name = {c.name: c for c in old_tmpl.cliques}
        for i, c in enumerate(new_tmpl.cliques):
            o = old_by_name[c.name]
            path = f"spec.template.cliques[{i}].spec"
            if c.spec.role_name != o.spec.role_name:
                errs.append(f"{path}.roleName is immutable")
            if c.spec.min_available != o.spec.min_available:
                errs.append(f"{path}.minAvailable is immutable")
            if list(c.spec.starts_after) != list(o.spec.starts_after):
                errs.append(f"{path}.startsAfter is immutable")
    if new_tmpl.startup_type != old_tmpl.startup_type:
        errs.append("spec.template.startupType is immutable")
    old_sgs = [(s.name, tuple(s.clique_names)) for s in old_tmpl.pod_clique_scaling_group_configs]
    new_sgs = [(s.name, tuple(s.clique_names)) for s in new_tmpl.pod_clique_scaling_group_configs]
    if old_sgs != new_sgs:
        errs.append("spec.template.podCliqueScalingGroupConfigs names/members are immutable")
    if errs:
        raise ValidationError(errs)
