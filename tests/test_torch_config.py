"""The port's operator configuration (`grove_tpu_torch/api/config.py`)
against the JAX package's.

The decode cases of tests/test_config.py run on the port; its cases that
built a `Harness` run on the port's Cluster, ControllerManager and
GangScheduler (the `Harness` and the workload controllers are not ported
yet); the durable store's knobs attach the port's journal
(tests/test_torch_durability.py holds it against the reference's). Then both packages load the same valid dicts, and
their `dataclasses.asdict` trees are equal field by field; and the same
invalid dicts, whose `ValidationError` messages are equal, message by
message, in order.
"""

from __future__ import annotations

import dataclasses

import pytest

from grove_tpu.api import config as jax_config
from grove_tpu_torch.api import ValidationError
from grove_tpu_torch.api import constants as constants_port
from grove_tpu_torch.api.config import (
    load_operator_config,
    validate_operator_config,
)
from grove_tpu_torch.cluster import Cluster, make_nodes
from grove_tpu_torch.convert import api_object

from test_torch_scheduler import JAX, TORCH, Plane, odd_gang, stress_inventory


class TestConfigDecode:
    def test_empty_dict_yields_defaults(self):
        cfg = load_operator_config({})
        assert cfg.workload_defaults.termination_delay_seconds == 4 * 3600
        assert cfg.solver.top_k == 8
        assert cfg.controllers.sync_retry_interval_seconds == 5.0
        assert cfg.autoscaler.tolerance == 0.1
        assert not cfg.authorization.enabled

    def test_nested_overrides(self):
        cfg = load_operator_config(
            {
                "workload_defaults": {"termination_delay_seconds": 60.0},
                "solver": {"top_k": 4, "native_repair": False},
                "log": {"level": "debug", "format": "json"},
            }
        )
        assert cfg.workload_defaults.termination_delay_seconds == 60.0
        assert cfg.solver.top_k == 4
        assert not cfg.solver.native_repair
        assert cfg.solver.commit_chunk == 32  # untouched default
        assert cfg.log.level == "debug"

    def test_unknown_field_rejected(self):
        with pytest.raises(ValidationError, match="unknown field"):
            load_operator_config({"solver": {"topk": 4}})

    def test_errors_aggregate(self):
        with pytest.raises(ValidationError) as e:
            load_operator_config(
                {
                    "solver": {"top_k": 0, "gang_bucket_minimum": 6},
                    "autoscaler": {"tolerance": 2.0},
                    "log": {"level": "verbose"},
                }
            )
        msgs = e.value.errors
        assert len(msgs) == 4, msgs
        assert any("top_k" in m for m in msgs)
        assert any("power of two" in m for m in msgs)
        assert any("tolerance" in m for m in msgs)
        assert any("log.level" in m for m in msgs)

    def test_authorization_validation(self):
        errs = validate_operator_config(
            load_operator_config({"authorization": {"enabled": True}})
        )
        assert errs == []
        with pytest.raises(ValidationError, match="operator_identity"):
            load_operator_config(
                {"authorization": {"enabled": True, "operator_identity": ""}}
            )

    def test_device_state_verify_requires_cache(self):
        errs = validate_operator_config(
            load_operator_config({"solver": {"device_state_cache": False}})
        )
        assert errs == []
        with pytest.raises(ValidationError, match="device_state_verify"):
            load_operator_config(
                {"solver": {"device_state_cache": False,
                            "device_state_verify": True}}
            )

    def test_backoff_fields_decode_and_defaults(self):
        cfg = load_operator_config({})
        assert cfg.controllers.error_backoff_base_seconds == 1.0
        assert cfg.controllers.error_backoff_max_seconds == 60.0
        assert cfg.controllers.error_retry_budget == 8
        cfg = load_operator_config(
            {"controllers": {"error_backoff_base_seconds": 0.5,
                             "error_backoff_max_seconds": 30.0,
                             "error_retry_budget": 3}}
        )
        assert cfg.controllers.error_backoff_base_seconds == 0.5
        assert cfg.controllers.error_backoff_max_seconds == 30.0
        assert cfg.controllers.error_retry_budget == 3

    def test_backoff_validation(self):
        with pytest.raises(ValidationError, match="error_backoff_base_seconds"):
            load_operator_config(
                {"controllers": {"error_backoff_base_seconds": 0}}
            )
        with pytest.raises(ValidationError, match="error_backoff_max_seconds"):
            load_operator_config(
                {"controllers": {"error_backoff_base_seconds": 10.0,
                                 "error_backoff_max_seconds": 5.0}}
            )
        with pytest.raises(ValidationError, match="error_retry_budget"):
            load_operator_config({"controllers": {"error_retry_budget": 0}})
        with pytest.raises(ValidationError, match="error_retry_budget"):
            load_operator_config({"controllers": {"error_retry_budget": 2.5}})
        with pytest.raises(ValidationError) as e:
            load_operator_config(
                {"controllers": {"error_backoff_base_seconds": -1,
                                 "error_backoff_max_seconds": "x",
                                 "error_retry_budget": True}}
            )
        assert sum("error_" in m for m in e.value.errors) == 3, e.value.errors

    def test_durability_defaults_and_decode(self):
        cfg = load_operator_config({})
        assert cfg.durability.wal_dir is None
        assert cfg.durability.fsync == "commit"
        assert cfg.durability.keep_snapshots == 2
        cfg = load_operator_config({"durability": {
            "wal_dir": "wal",
            "fsync": "snapshot",
            "snapshot_interval_seconds": 60.0,
            "wal_max_bytes": 1 << 20,
            "keep_snapshots": 3,
        }})
        assert cfg.durability.wal_dir == "wal"
        assert cfg.durability.fsync == "snapshot"
        assert cfg.durability.snapshot_interval_seconds == 60.0

    def test_durability_rejected_combinations(self):
        with pytest.raises(ValidationError, match="wal_dir"):
            load_operator_config({"durability": {"wal_dir": ""}})
        with pytest.raises(ValidationError, match="fsync"):
            load_operator_config({"durability": {"fsync": "always"}})
        with pytest.raises(ValidationError, match="snapshot_interval_seconds"):
            load_operator_config(
                {"durability": {"snapshot_interval_seconds": 0}}
            )
        with pytest.raises(ValidationError, match="wal_max_bytes"):
            load_operator_config({"durability": {"wal_max_bytes": 512}})
        with pytest.raises(ValidationError, match="keep_snapshots"):
            load_operator_config({"durability": {"keep_snapshots": 1}})
        with pytest.raises(ValidationError) as e:
            load_operator_config({"durability": {
                "fsync": "maybe",
                "wal_max_bytes": -1,
                "keep_snapshots": 0,
            }})
        assert sum("durability" in m for m in e.value.errors) == 3

    def test_topology_levels_validation(self):
        with pytest.raises(ValidationError, match="duplicate domain"):
            load_operator_config(
                {
                    "topology_aware_scheduling": {
                        "levels": [
                            {"domain": "rack", "key": "a"},
                            {"domain": "rack", "key": "b"},
                        ]
                    }
                }
            )


def plane(config: dict, nodes: int = 32, engine_cls=None) -> Plane:
    nodes_j, ct = stress_inventory(nodes)
    return Plane(TORCH, [api_object(n) for n in nodes_j], api_object(ct),
                 config, engine_cls=engine_cls)


class TestConfigChangesBehavior:
    """The cases of tests/test_config.py that drove a Harness, on the
    port's Cluster, ControllerManager and GangScheduler."""

    def test_backoff_knobs_reach_manager(self):
        pl = plane({"controllers": {"error_backoff_base_seconds": 2.0,
                                    "error_backoff_max_seconds": 40.0,
                                    "error_retry_budget": 4}})
        assert pl.manager.error_backoff_base_seconds == 2.0
        assert pl.manager.error_backoff_max_seconds == 40.0
        assert pl.manager.error_retry_budget == 4

    def test_durable_store_attaches_its_journal(self, tmp_path):
        """`config.durability` (refused until ROADMAP item 8b was
        ported): a wal_dir attaches the journal the config names, one WAL
        or `partitions` of them, with the config's fsync policy."""
        from grove_tpu_torch.cluster.durability import (
            DurableLog,
            PartitionedLog,
        )

        for parts, cls in ((1, DurableLog), (3, PartitionedLog)):
            cfg = load_operator_config(
                {"durability": {"wal_dir": str(tmp_path / f"wal{parts}"),
                                "fsync": "commit", "partitions": parts}})
            c = Cluster(nodes=make_nodes(2), config=cfg)
            assert type(c.durability) is cls
            assert c.store.durability is c.durability
            assert c.durability.wal_records_total > 0
        assert Cluster(nodes=make_nodes(2)).durability is None

    @pytest.mark.parametrize("section", ["replication", "slo"])
    def test_unported_sections_raise(self, section):
        """The two sections that raised NotImplementedError until ROADMAP
        items 8d and 8e were ported (the test keeps its name from then)
        now build as the reference's do: switched on after the load (the
        validation lets replication on only with a durable store), the SLO
        section builds the cluster's SLO engine on its metrics and clock,
        and replication without a journal builds no standby and no link,
        in both packages alike."""
        from grove_tpu.api.config import load_operator_config as jax_load
        from grove_tpu.cluster.cluster import Cluster as JaxCluster
        from grove_tpu.cluster import make_nodes as jax_nodes

        clusters = []
        for load, cls, nodes in ((jax_load, JaxCluster, jax_nodes),
                                 (load_operator_config, Cluster, make_nodes)):
            cfg = load({})
            getattr(cfg, section).enabled = True
            clusters.append(cls(nodes=nodes(2), config=cfg))
        jax_c, c = clusters
        for have in (jax_c, c):
            if section == "slo":
                assert have.slo is not None
                assert have.slo.metrics is have.metrics
                assert have.slo.clock is have.clock
            else:
                assert have.standby is None and have.replication_link is None
        if section == "slo":
            assert c.slo.scorecard() == jax_c.slo.scorecard()

    def test_workload_defaults_flow_into_admission(self):
        from test_cluster import simple_pcs

        c = Cluster(nodes=make_nodes(4), config=load_operator_config({
            "workload_defaults": {"termination_delay_seconds": 123.0,
                                  "replicas": 2}}))
        pcs = api_object(simple_pcs())
        pcs.spec.replicas = None  # let defaulting fill it
        live = c.store.create(pcs)
        assert live.spec.template.termination_delay == 123.0
        assert live.spec.replicas == 2

    def test_scheduler_retry_interval_from_config(self):
        pl = plane({"controllers": {"sync_retry_interval_seconds": 60.0}},
                   nodes=1)
        gang, pods = odd_gang("w", 2, 64.0)
        pl.create([api_object(p) for p in pods] + [api_object(gang)])
        pl.settle()
        assert all(not p.node_name for p in pl.store.scan("Pod"))
        next_retry = pl.manager.next_requeue_at()
        assert next_retry == pytest.approx(pl.cluster.clock.now() + 60.0,
                                           abs=1e-6)

    def test_solver_knobs_reach_engine(self):
        from grove_tpu_torch.solver import PlacementEngine

        captured = {}

        class Probe:
            def __init__(self, snapshot, device=None, **kwargs):
                captured.update(kwargs, device=device)
                self._e = PlacementEngine(snapshot, device=device, **kwargs)

            def solve(self, gangs, free=None):
                return self._e.solve(gangs, free=free)

        pl = plane({"solver": {
            "top_k": 3, "commit_chunk": 16, "gang_bucket_minimum": 4,
            "native_repair": False, "device_state_cache": True,
            "device_state_verify": True,
        }}, engine_cls=Probe)
        gang, pods = odd_gang("w", 2, 1.0)
        pl.create([api_object(p) for p in pods] + [api_object(gang)])
        pl.settle()
        assert captured.pop("metrics") is pl.cluster.metrics
        assert captured.pop("decision_log") is pl.cluster.decisions
        assert captured == {
            "device": "cpu",
            "top_k": 3,
            "commit_chunk": 16,
            "bucket_min": 4,
            "native_repair": False,
            "state_cache": True,
            "state_verify": True,
            "fused": True,
            "incremental": True,
            "hierarchical": True,
            "hier_prune_level": None,
            "hier_min_nodes": 4096,
            "hier_parallel_workers": None,
            "pallas_core": None,
            "device_commit": None,
            "pallas_precision": "fp32",
        }
        assert all(p.node_name for p in pl.store.scan("Pod"))

    def test_topology_levels_seed_bootstrap(self):
        nodes = make_nodes(4, racks_per_block=2, hosts_per_rack=2)
        for i, n in enumerate(nodes):
            n.metadata.labels["t/zone"] = f"z{i % 2}"
        c = Cluster(nodes=nodes, config=load_operator_config({
            "topology_aware_scheduling": {
                "levels": [{"domain": "zone", "key": "t/zone"}]}}))
        assert "t/zone" in c.topology_snapshot().level_keys


#: valid configs: every section with some knob moved off its default
VALID = [
    {},
    {"workload_defaults": {"termination_delay_seconds": 60.0, "replicas": 3}},
    {"solver": {"top_k": 4, "native_repair": False, "commit_chunk": 16,
                "hierarchical_solve": False, "pallas_core": True,
                "device_commit": True, "pallas_precision": "bf16"}},
    {"controllers": {"error_backoff_base_seconds": 0.5,
                     "error_retry_budget": 3,
                     "sync_retry_interval_seconds": 7.5}},
    {"log": {"level": "debug", "format": "json"}},
    {"authorization": {"enabled": True}},
    {"tenancy": {"enabled": True, "tenants": [
        {"name": "a", "guaranteed": {"cpu": 8.0}, "weight": 2.0},
        {"name": "b", "burst": {"cpu": 16.0}, "parent": "a",
         "disruption_budget": 1}]}},
    {"topology_aware_scheduling": {"levels": [
        {"domain": "zone", "key": "t/zone"},
        {"domain": "rack", "key": "t/rack"}]}},
    {"durability": {"wal_dir": "wal", "fsync": "never", "partitions": 4}},
    {"tracing": {"enabled": True, "mode": "aggregate"}},
    {"autoscaler": {"tolerance": 0.2}},
    {"serving": {"enabled": True,
                 "trace": {"base_rps": 126.0, "peak_rps": 126.0, "noise": 0.0},
                 "workloads": [{"clique": "be", "shape": "decode",
                                "rps_per_replica": 10.0,
                                "demand_fraction": 1.0}]}},
    {"defrag": {"enabled": True}},
    {"stream": {"enabled": True}},
]

#: invalid configs: unknown fields, wrong types and ranges, bad
#: combinations, in several sections at once
INVALID = [
    {"solver": {"topk": 4}},
    {"solver": {"top_k": 0, "gang_bucket_minimum": 6},
     "autoscaler": {"tolerance": 2.0}, "log": {"level": "verbose"}},
    {"authorization": {"enabled": True, "operator_identity": ""}},
    {"solver": {"device_state_cache": False, "device_state_verify": True}},
    {"controllers": {"error_backoff_base_seconds": -1,
                     "error_backoff_max_seconds": "x",
                     "error_retry_budget": True}},
    {"durability": {"fsync": "maybe", "wal_max_bytes": -1,
                    "keep_snapshots": 0}},
    {"topology_aware_scheduling": {"levels": [
        {"domain": "rack", "key": "a"}, {"domain": "rack", "key": "b"}]}},
    {"tenancy": {"enabled": True, "tiers": []}},
    {"tenancy": {"enabled": True, "tenants": [{"name": "a", "weight": 0}]}},
    {"solver": {"pallas_precision": "fp16", "pallas_core": "yes"}},
    {"serving": {"enabled": True}},
    {"serving": {"trace": {"base_rps": 100.0, "peak_rps": 50.0,
                           "noise": -1, "bogus": 1}}},
    {"serving": {"workloads": [{"clique": "a", "shape": "nosuch"},
                               {"clique": "a", "demand_fraction": 2.0},
                               {"shape": "decode"}]}},
    {"serving": {"enabled": True, "workloads": [{"name": "w"}]}},
    {"nonsense": {}},
]


def _load_or_errors(load, error_cls, cfg):
    try:
        return load(cfg), None
    except error_cls as exc:
        return None, list(exc.errors)


@pytest.mark.parametrize("cfg", VALID, ids=lambda c: "-".join(c) or "empty")
def test_valid_configs_load_alike(cfg):
    ours, err = _load_or_errors(load_operator_config, ValidationError, cfg)
    ref, ref_err = _load_or_errors(jax_config.load_operator_config,
                                   JAX.api.ValidationError, cfg)
    assert err is None and ref_err is None, (err, ref_err)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours == api_object(ref)


@pytest.mark.parametrize("cfg", INVALID, ids=lambda c: "-".join(c))
def test_invalid_configs_fail_alike(cfg):
    _, err = _load_or_errors(load_operator_config, ValidationError, cfg)
    _, ref_err = _load_or_errors(jax_config.load_operator_config,
                                 JAX.api.ValidationError, cfg)
    assert ref_err, cfg
    assert err == ref_err


class TestAuthorization:
    """Managed-resource protection on the port's store (the cases of
    tests/test_config.py's TestAuthorization over PodGangs and Pods the
    operator identity wrote, stamped managed-by): the scheduler, running
    as the operator identity, binds them alike in both packages; a user
    may not update them, may delete a Pod, and is let through by an
    exempt identity or the disable-protection annotation, on the object
    or on its owning PodCliqueSet."""

    def pair(self, **az):
        from test_torch_scheduler import Pair

        return Pair({"authorization": {"enabled": True, **az}}, nodes=16)

    def managed(self, pair, name, part_of=""):
        gang, pods = odd_gang(name, 2, 1.0, required=None)
        for obj in [gang, *pods]:
            obj.metadata.labels[JAX.constants.LABEL_MANAGED_BY] = (
                JAX.constants.LABEL_MANAGED_BY_VALUE)
            if part_of:
                obj.metadata.labels[JAX.constants.LABEL_PART_OF] = part_of
        operator = pair.j.config.authorization.operator_identity

        def create(pl, cv):
            with pl.store.impersonate(operator):
                pl.create(cv(pods) + cv([gang]))

        pair.both(create)

    def test_scheduler_binds_managed_gangs_and_users_are_refused(self):
        from grove_tpu_torch.cluster.store import Forbidden

        pair = self.pair()
        self.managed(pair, "w")
        st = pair.settle_and_compare("managed gang bound")
        assert all(node for node, _ in st["pods"].values())
        store = pair.t.store
        gang = store.get("PodGang", "bench", "w")
        gang.spec.priority_class_name = "tampered"
        with pytest.raises(Forbidden, match="may not update"):
            store.update(gang)
        pod = store.get("Pod", "bench", "w-p0")
        pod.spec.priority_class_name = "tampered"
        with pytest.raises(Forbidden, match="may not update"):
            store.update(pod)
        store.delete("Pod", "bench", "w-p0")  # pod deletion is permitted

    def test_exempt_actor_and_disable_annotation(self):
        pair = self.pair(exempt_actors=["admin@corp"])
        self.managed(pair, "w")
        pair.settle_and_compare("managed gang bound")
        store = pair.t.store
        gang = store.get("PodGang", "bench", "w")
        gang.metadata.annotations[
            constants_port.ANNOTATION_DISABLE_MANAGED_RESOURCE_PROTECTION
        ] = "true"
        with store.impersonate("admin@corp"):
            store.update(gang)
        fresh = store.get("PodGang", "bench", "w")
        fresh.metadata.labels["x"] = "y"
        store.update(fresh)  # opted out: the user may touch it

    def test_disable_protection_via_owning_pcs(self):
        from test_cluster import simple_pcs

        pair = self.pair()
        pcs = simple_pcs(name="owner")
        pcs.metadata.namespace = "bench"
        pcs.metadata.annotations[
            JAX.constants.ANNOTATION_DISABLE_MANAGED_RESOURCE_PROTECTION
        ] = "true"
        pair.both(lambda pl, cv: pl.create(cv([pcs])))
        self.managed(pair, "w", part_of="owner")
        pair.settle_and_compare("managed gang of an opted-out set")
        gang = pair.t.store.get("PodGang", "bench", "w")
        gang.metadata.labels["x"] = "y"
        pair.t.store.update(gang)
