"""The port's API layer: naming, defaulting, validation (webhook parity).

The cases of tests/test_api.py run on grove_tpu_torch.api, then the same
seeded PodCliqueSets, valid and invalid, through both packages'
`default_podcliqueset` and `validate_podcliqueset`: the defaulted objects
equal field by field (dataclasses.asdict, enum members by value) and the
error messages identical, word for word.
"""

import dataclasses
import enum

import numpy as np
import pytest

import grove_tpu.api as jax_api

from grove_tpu_torch import api
from grove_tpu_torch.api import naming


def make_pcs(name="simple1", cliques=None, sgs=None, startup=None, replicas=1):
    cliques = cliques if cliques is not None else [
        api.PodCliqueTemplateSpec(
            name="frontend",
            spec=api.PodCliqueSpec(
                replicas=2,
                pod_spec=api.PodSpec(
                    containers=[api.Container(name="c", resources={"cpu": 1})]
                ),
            ),
        )
    ]
    pcs = api.PodCliqueSet(
        metadata=api.ObjectMeta(name=name),
        spec=api.PodCliqueSetSpec(
            replicas=replicas,
            template=api.PodCliqueSetTemplateSpec(
                cliques=cliques,
                pod_clique_scaling_group_configs=sgs or [],
                startup_type=startup,
            ),
        ),
    )
    return pcs


class TestNaming:
    def test_grammar(self):
        assert naming.podclique_name("pcs", 0, "decode") == "pcs-0-decode"
        assert naming.pcsg_name("pcs", 1, "sga") == "pcs-1-sga"
        assert naming.base_podgang_name("pcs", 2) == "pcs-2"
        assert naming.scaled_podgang_name("pcs-0-sga", 0) == "pcs-0-sga-0"
        assert naming.pod_name("pcs-0-decode", 3) == "pcs-0-decode-3"

    def test_pcsg_replica_gang_routing(self):
        # Replicas below minAvailable belong to the base gang; beyond get
        # 0-based scaled gangs (namegen.go:100-115).
        assert (
            naming.podgang_name_for_pcsg_replica("pcs", 0, "pcs-0-sga", 1, 2)
            == "pcs-0"
        )
        assert (
            naming.podgang_name_for_pcsg_replica("pcs", 0, "pcs-0-sga", 2, 2)
            == "pcs-0-sga-0"
        )
        assert (
            naming.podgang_name_for_pcsg_replica("pcs", 0, "pcs-0-sga", 4, 2)
            == "pcs-0-sga-2"
        )


class TestDefaulting:
    def test_defaults_applied(self):
        pcs = make_pcs()
        pcs.spec.template.cliques[0].spec.min_available = None
        api.default_podcliqueset(pcs)
        tmpl = pcs.spec.template
        assert tmpl.startup_type == api.CliqueStartupType.ANY_ORDER
        assert tmpl.termination_delay == 4 * 3600
        assert tmpl.head_less_service_config.publish_not_ready_addresses
        assert tmpl.cliques[0].spec.min_available == 2  # defaults to replicas

    def test_pcsg_defaults(self):
        sgs = [api.PodCliqueScalingGroupConfig(name="sga", clique_names=["frontend"])]
        pcs = make_pcs(sgs=sgs)
        api.default_podcliqueset(pcs)
        sg = pcs.spec.template.pod_clique_scaling_group_configs[0]
        assert sg.replicas == 1 and sg.min_available == 1


class TestValidation:
    def _validate(self, pcs):
        api.default_podcliqueset(pcs)
        api.validate_podcliqueset(pcs)

    def test_valid_passes(self):
        self._validate(make_pcs())

    def test_bad_name(self):
        with pytest.raises(api.ValidationError, match="DNS-1123"):
            self._validate(make_pcs(name="Bad_Name"))

    def test_duplicate_clique_names(self):
        cl = [
            api.PodCliqueTemplateSpec(name="a", spec=api.PodCliqueSpec()),
            api.PodCliqueTemplateSpec(name="a", spec=api.PodCliqueSpec(role_name="b")),
        ]
        with pytest.raises(api.ValidationError, match="duplicate clique name"):
            self._validate(make_pcs(cliques=cl))

    def test_min_available_bounds(self):
        pcs = make_pcs()
        pcs.spec.template.cliques[0].spec.min_available = 5  # > replicas=2
        with pytest.raises(api.ValidationError, match="minAvailable"):
            self._validate(pcs)

    def test_starts_after_requires_explicit(self):
        cl = [
            api.PodCliqueTemplateSpec(name="a", spec=api.PodCliqueSpec()),
            api.PodCliqueTemplateSpec(
                name="b", spec=api.PodCliqueSpec(role_name="rb", starts_after=["a"])
            ),
        ]
        with pytest.raises(api.ValidationError, match="Explicit"):
            self._validate(make_pcs(cliques=cl))

    def test_starts_after_unknown_target(self):
        cl = [
            api.PodCliqueTemplateSpec(
                name="a", spec=api.PodCliqueSpec(starts_after=["ghost"])
            )
        ]
        with pytest.raises(api.ValidationError, match="unknown clique"):
            self._validate(make_pcs(cliques=cl, startup=api.CliqueStartupType.EXPLICIT))

    def test_cycle_detection(self):
        # a -> b -> c -> a (validation/podcliqueset.go:278-300 SCC parity).
        cl = [
            api.PodCliqueTemplateSpec(
                name="a", spec=api.PodCliqueSpec(starts_after=["c"])
            ),
            api.PodCliqueTemplateSpec(
                name="b", spec=api.PodCliqueSpec(role_name="rb", starts_after=["a"])
            ),
            api.PodCliqueTemplateSpec(
                name="c", spec=api.PodCliqueSpec(role_name="rc", starts_after=["b"])
            ),
        ]
        with pytest.raises(api.ValidationError, match="cycle"):
            self._validate(make_pcs(cliques=cl, startup=api.CliqueStartupType.EXPLICIT))

    def test_diamond_dag_ok(self):
        cl = [
            api.PodCliqueTemplateSpec(name="a", spec=api.PodCliqueSpec()),
            api.PodCliqueTemplateSpec(
                name="b", spec=api.PodCliqueSpec(role_name="rb", starts_after=["a"])
            ),
            api.PodCliqueTemplateSpec(
                name="c", spec=api.PodCliqueSpec(role_name="rc", starts_after=["a"])
            ),
            api.PodCliqueTemplateSpec(
                name="d",
                spec=api.PodCliqueSpec(role_name="rd", starts_after=["b", "c"]),
            ),
        ]
        self._validate(make_pcs(cliques=cl, startup=api.CliqueStartupType.EXPLICIT))

    def test_pcsg_unknown_clique(self):
        sgs = [api.PodCliqueScalingGroupConfig(name="sga", clique_names=["ghost"])]
        with pytest.raises(api.ValidationError, match="unknown clique"):
            self._validate(make_pcs(sgs=sgs))

    def test_pcsg_no_overlap(self):
        cl = [
            api.PodCliqueTemplateSpec(name="a", spec=api.PodCliqueSpec()),
            api.PodCliqueTemplateSpec(name="b", spec=api.PodCliqueSpec(role_name="rb")),
        ]
        sgs = [
            api.PodCliqueScalingGroupConfig(name="sg1", clique_names=["a"]),
            api.PodCliqueScalingGroupConfig(name="sg2", clique_names=["a", "b"]),
        ]
        with pytest.raises(api.ValidationError, match="already claimed"):
            self._validate(make_pcs(cliques=cl, sgs=sgs))

    def test_no_clique_hpa_inside_pcsg(self):
        cl = [
            api.PodCliqueTemplateSpec(
                name="a",
                spec=api.PodCliqueSpec(
                    scale_config=api.AutoScalingConfig(min_replicas=1, max_replicas=3)
                ),
            )
        ]
        sgs = [api.PodCliqueScalingGroupConfig(name="sga", clique_names=["a"])]
        with pytest.raises(api.ValidationError, match="scale only via the group"):
            self._validate(make_pcs(cliques=cl, sgs=sgs))

    def test_topology_strictness(self):
        # PCS requires rack-level pack; clique must not be broader (zone).
        pcs = make_pcs()
        pcs.spec.template.topology_constraint = api.TopologyConstraintSpec(
            pack_constraint=api.TopologyPackConstraintSpec(required="rack")
        )
        pcs.spec.template.cliques[0].spec.topology_constraint = (
            api.TopologyConstraintSpec(
                pack_constraint=api.TopologyPackConstraintSpec(required="zone")
            )
        )
        with pytest.raises(api.ValidationError, match="narrow"):
            self._validate(pcs)

    def test_update_immutability(self):
        old = make_pcs()
        new = make_pcs()
        new.spec.template.cliques = [
            api.PodCliqueTemplateSpec(name="other", spec=api.PodCliqueSpec())
        ]
        with pytest.raises(api.ValidationError, match="immutable"):
            api.validate_podcliqueset_update(old, new)


class TestConditions:
    def test_set_condition_flip_detection(self):
        conds = []
        assert api.set_condition(conds, "MinAvailableBreached", "True", now=1.0)
        assert not api.set_condition(conds, "MinAvailableBreached", "True", now=2.0)
        assert conds[0].last_transition_time == 1.0
        assert api.set_condition(conds, "MinAvailableBreached", "False", now=3.0)
        assert conds[0].last_transition_time == 3.0


def clique(name, replicas=2, min_available=None, starts_after=()):
    return api.PodCliqueTemplateSpec(
        name=name,
        spec=api.PodCliqueSpec(
            replicas=replicas,
            min_available=min_available,
            starts_after=list(starts_after),
            pod_spec=api.PodSpec(
                containers=[api.Container(name="c", resources={"cpu": 1})]
            ),
        ),
    )


def admit(pcs):
    api.default_podcliqueset(pcs)
    api.validate_podcliqueset(pcs)
    return pcs


class TestReviewFixes:
    """Behaviors pinned after the round-1 code review."""

    def test_pcsg_name_budget_includes_group_name(self):
        sgs = [api.PodCliqueScalingGroupConfig(
            name="prefill-workers-group", clique_names=["decode"])]
        pcs = make_pcs(name="inference-serving-clu",
                       cliques=[clique("decode")], sgs=sgs)
        with pytest.raises(api.ValidationError, match="exceeds"):
            admit(pcs)

    def test_unknown_topology_domain_sort_raises(self):
        with pytest.raises(ValueError, match="unknown topology domain"):
            api.sort_topology_levels(
                [api.TopologyLevel(domain="cube", key="topo/cube")])

    def test_invalid_scale_config_min_replicas_rejected_not_coerced(self):
        pcs = make_pcs(cliques=[clique("a")])
        pcs.spec.template.cliques[0].spec.scale_config = api.AutoScalingConfig(
            min_replicas=0, max_replicas=4)
        with pytest.raises(api.ValidationError, match="minReplicas must be >= 1"):
            admit(pcs)

    def test_self_loop_reported_once(self):
        pcs = make_pcs(cliques=[clique("a", starts_after=["a"])],
                       startup=api.CliqueStartupType.EXPLICIT)
        with pytest.raises(api.ValidationError) as ei:
            admit(pcs)
        assert len(ei.value.errors) == 1
        assert "cycle" in ei.value.errors[0]

    def test_update_minavailable_immutable_but_reorder_ok_anyorder(self):
        from grove_tpu_torch.api.validation import validate_podcliqueset_update

        old = admit(make_pcs(cliques=[clique("a"), clique("b")]))
        new = admit(make_pcs(cliques=[clique("b"), clique("a")]))
        validate_podcliqueset_update(old, new)  # reorder OK under AnyOrder

        new2 = admit(make_pcs(cliques=[clique("a", min_available=1), clique("b")]))
        with pytest.raises(api.ValidationError, match="minAvailable is immutable"):
            validate_podcliqueset_update(old, new2)

    def test_update_reorder_rejected_when_explicit(self):
        from grove_tpu_torch.api.validation import validate_podcliqueset_update

        old = admit(make_pcs(cliques=[clique("a"), clique("b")],
                             startup=api.CliqueStartupType.EXPLICIT))
        new = admit(make_pcs(cliques=[clique("b"), clique("a")],
                             startup=api.CliqueStartupType.EXPLICIT))
        with pytest.raises(api.ValidationError, match="order is immutable"):
            validate_podcliqueset_update(old, new)

    def test_cluster_topology_validation(self):
        from grove_tpu_torch.api.types import (
            ClusterTopology, ClusterTopologySpec, TopologyLevel,
        )

        bad = ClusterTopology(spec=ClusterTopologySpec(levels=[
            TopologyLevel(domain="cube", key="t/cube"),
            TopologyLevel(domain="rack", key="t/rack"),
            TopologyLevel(domain="rack", key="t/rack"),
            TopologyLevel(domain="zone", key=""),
        ]))
        with pytest.raises(api.ValidationError) as ei:
            api.validate_cluster_topology(bad)
        msgs = " ".join(ei.value.errors)
        assert "unknown topology domain" in msgs
        assert "duplicate domain" in msgs
        assert "must not be empty" in msgs
        ok = ClusterTopology(spec=ClusterTopologySpec(levels=[
            TopologyLevel(domain="rack", key="t/rack")]))
        api.validate_cluster_topology(ok)

    def test_update_order_and_field_violations_reported_together(self):
        from grove_tpu_torch.api.validation import validate_podcliqueset_update

        old = admit(make_pcs(cliques=[clique("a"), clique("b")],
                             startup=api.CliqueStartupType.EXPLICIT))
        new = admit(make_pcs(cliques=[clique("b"), clique("a", min_available=1)],
                             startup=api.CliqueStartupType.EXPLICIT))
        with pytest.raises(api.ValidationError) as ei:
            validate_podcliqueset_update(old, new)
        msgs = " ".join(ei.value.errors)
        assert "order is immutable" in msgs and "minAvailable is immutable" in msgs

    def test_standalone_name_budget_matches_reference_formula(self):
        # 20-char pcs + 25-char clique = 45 exactly -> accepted
        pcs = make_pcs(name="a" * 20, cliques=[clique("b" * 25)])
        admit(pcs)
        pcs2 = make_pcs(name="a" * 20, cliques=[clique("b" * 26)])
        with pytest.raises(api.ValidationError, match="exceeds"):
            admit(pcs2)

    def test_exact_generated_name_budget_counts_index_digits(self):
        # Boundary: combined components = 45 (passes the reference formula)
        # but replica-digit widths push the worst-case generated hostname
        # '<pcs>-<i>-<clique>-<k>' past a 63-char DNS label -> rejected.
        c = clique("b" * 25)
        c.spec.replicas = 2
        c.spec.scale_config = api.AutoScalingConfig(
            min_replicas=1, max_replicas=10**12, target_utilization=0.5
        )
        pcs = make_pcs(name="a" * 20, cliques=[c], replicas=10**4)
        # 20 + 1 + 4 + 1 + 25 + 1 + 12 = 64 > 63
        with pytest.raises(api.ValidationError, match="worst-case generated"):
            admit(pcs)
        # Same shapes with modest scale bounds fit: accepted
        c.spec.scale_config.max_replicas = 100
        pcs_ok = make_pcs(name="a" * 20, cliques=[c], replicas=10**4)
        admit(pcs_ok)  # 20+1+4+1+25+1+2 = 54 <= 63

    def test_exact_generated_name_budget_pcsg(self):
        # PCSG hostnames carry two extra components; huge HPA bounds on the
        # group overflow the DNS label even when the 45 budget holds.
        member = clique("c" * 15)
        member.spec.replicas = 4
        sg = api.PodCliqueScalingGroupConfig(
            name="s" * 10, clique_names=[member.name], replicas=2,
            min_available=1,
            scale_config=api.AutoScalingConfig(
                min_replicas=1, max_replicas=10**12, target_utilization=0.5
            ),
        )
        pcs = make_pcs(name="a" * 20, cliques=[member], sgs=[sg])
        # 20+1+1+1+10+1+12+1+15+1+1 = 64 > 63
        with pytest.raises(api.ValidationError, match="worst-case generated"):
            admit(pcs)
        sg.scale_config.max_replicas = 100
        admit(make_pcs(name="a" * 20, cliques=[member], sgs=[sg]))


# -- the two packages on the same specs ---------------------------------------


def plain(obj):
    """dataclasses.asdict with enum members as their values, so objects of
    the two packages compare."""
    def conv(x):
        if isinstance(x, enum.Enum):
            return x.value
        if isinstance(x, dict):
            return {conv(k): conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return x
    return conv(dataclasses.asdict(obj))


def seeded_pcs(mod, seed: int, flaw: str | None):
    """A seeded PodCliqueSet built from package `mod`'s api: 2-5 cliques
    with random replicas, min_available and startsAfter edges along the
    clique order (a DAG), Explicit startup, 0-2 scaling groups over
    disjoint cliques and a zone/block topology constraint. `flaw`:
    "cycle" closes a startsAfter cycle, "unknown" puts an unknown clique
    in a scaling group, "overlap" makes two scaling groups share one."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 6))
    names = [f"c{i}" for i in range(n)]
    cliques = []
    for i, name in enumerate(names):
        replicas = int(rng.integers(1, 5))
        after = [names[j] for j in range(i) if rng.random() < 0.4]
        cliques.append(mod.PodCliqueTemplateSpec(
            name=name,
            spec=mod.PodCliqueSpec(
                role_name=name,
                replicas=replicas,
                min_available=(int(rng.integers(1, replicas + 1))
                               if rng.random() < 0.5 else None),
                starts_after=after,
                pod_spec=mod.PodSpec(containers=[mod.Container(
                    name="c", resources={"cpu": float(rng.integers(1, 8))})]),
            ),
        ))
    if flaw == "cycle":
        cliques[0].spec.starts_after.append(names[-1])
        cliques[-1].spec.starts_after.append(names[0])
    sgs = [mod.PodCliqueScalingGroupConfig(
        name="sga", clique_names=[names[1]],
        replicas=int(rng.integers(1, 4)))]
    if flaw == "unknown":
        sgs[0].clique_names.append("nosuch")
    if flaw == "overlap":
        sgs.append(mod.PodCliqueScalingGroupConfig(
            name="sgb", clique_names=[names[1], names[2]]))
    return mod.PodCliqueSet(
        metadata=mod.ObjectMeta(name=f"pcs{seed}"),
        spec=mod.PodCliqueSetSpec(
            replicas=int(rng.integers(1, 3)),
            template=mod.PodCliqueSetTemplateSpec(
                cliques=cliques,
                pod_clique_scaling_group_configs=sgs,
                startup_type=mod.CliqueStartupType.EXPLICIT,
                topology_constraint=mod.TopologyConstraintSpec(
                    pack_constraint=mod.TopologyPackConstraintSpec(
                        required="zone", preferred="block")),
            ),
        ),
    )


def default_then_validate(mod, pcs):
    """(the defaulted object as plain data, the validation errors)."""
    mod.default_podcliqueset(pcs)
    try:
        mod.validate_podcliqueset(pcs)
        errors = []
    except mod.ValidationError as e:
        errors = list(e.errors)
    return plain(pcs), errors


@pytest.mark.parametrize("flaw", [None, "cycle", "unknown", "overlap"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_and_validate_match_the_jax_package(seed, flaw):
    """Field-equal defaulted objects and identical error messages; the
    flawed specs fail, the valid ones pass."""
    got = default_then_validate(api, seeded_pcs(api, seed, flaw))
    want = default_then_validate(jax_api, seeded_pcs(jax_api, seed, flaw))
    assert got == want
    assert bool(got[1]) == (flaw is not None)


def test_find_cycles_matches_the_jax_package():
    rng = np.random.default_rng(5)
    for _ in range(20):
        edges = {f"n{i}": [f"n{j}" for j in range(8) if rng.random() < 0.2]
                 for i in range(8)}
        assert api.find_cycles(edges) == jax_api.find_cycles(edges)
