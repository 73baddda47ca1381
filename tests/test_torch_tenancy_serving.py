"""The port's tenancy (`grove_tpu_torch/tenancy/`) and serving
(`grove_tpu_torch/serving/`) against the JAX package's.

- The cases of tests/test_tenancy.py and tests/test_serving.py that need
  no `Harness`, on the port: tenancy config validation, admission bands,
  fairness ordering in the serial, engine (device="cpu") and native
  solves, the QuotaExceeded code; the traffic trace, the workload
  shapes, the metrics pipeline and the serving config.
- Their `Harness` cases whose behaviour the scheduler alone carries
  (quota sheds with QuotaExceeded everywhere, re-admission once usage
  drops, the PodGang tier defaulting and validation, the seeded tiers,
  the per-tenant series hygiene, DRF entitlements) on the port's
  Cluster/ControllerManager/GangScheduler over PodGangs, each run in both
  packages with equal outcomes.
- `TenancyManager` admit, queue and shed decisions over one seeded
  sequence, and `PodMetrics` and `TrafficTrace` from one seed, with the
  kubelet reporting through a `TrafficEngine`: equal in both packages.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import grove_tpu.serving as jax_serving
import grove_tpu.tenancy as jax_tenancy
from grove_tpu.api.config import load_operator_config as jax_load
from grove_tpu_torch.api import constants
from grove_tpu_torch.api.config import load_operator_config
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.podgang import PodGang, PodGangSpec
from grove_tpu_torch.api.validation import ValidationError
from grove_tpu_torch.convert import (
    GANG_FIELDS,
    SNAPSHOT_FIELDS,
    gang_from_arrays,
    snapshot_from_arrays,
)
from grove_tpu_torch.observability.explain import (
    UnsatCode,
    UnsatDiagnosis,
    unsat_code,
    unsat_preemptible,
)
from grove_tpu_torch.serving import (
    PodMetrics,
    SpikeEvent,
    TrafficTrace,
    WorkloadShape,
)
from grove_tpu_torch.solver import PlacementEngine, solve_serial
from grove_tpu_torch.tenancy import ADMIT, QUEUE, SHED, TenancyManager

from test_solver import cluster as jax_cluster
from test_solver import gang as jax_gang
from test_torch_scheduler import JAX, TORCH, Pair, metric_values, odd_gang


def solver_cluster(**kw):
    snap = jax_cluster(**kw)
    return snapshot_from_arrays(**{f: getattr(snap, f)
                                   for f in SNAPSHOT_FIELDS})


def solver_gang(*args, **kw):
    g = jax_gang(*args, **kw)
    return gang_from_arrays(**{f: getattr(g, f) for f in GANG_FIELDS})


def tenancy_cfg(tenants, **kw):
    base = {"enabled": True, "tenants": tenants}
    base.update(kw)
    return load_operator_config({"tenancy": base}).tenancy


# -- tenancy config -----------------------------------------------------------
class TestTenancyConfig:
    def test_valid_config_loads(self):
        cfg = tenancy_cfg([
            {"name": "a", "guaranteed": {"cpu": 8.0},
             "burst": {"cpu": 16.0}, "weight": 2.0, "tier": "high"},
            {"name": "b", "parent": "a", "disruption_budget": 1},
        ])
        assert cfg.enabled
        assert [t["name"] for t in cfg.tenants] == ["a", "b"]

    @pytest.mark.parametrize("tenants,needle", [
        ([{"name": "a", "guaranteed": {"cpu": 8.0},
           "burst": {"cpu": 4.0}}], "burst"),
        ([{"name": "a", "parent": "ghost"}], "unknown tenant"),
        ([{"name": "a", "parent": "b"}, {"name": "b", "parent": "a"}],
         "cycle"),
        ([{"name": "a", "tier": "platinum"}], "unknown tier"),
        ([{"name": "a"}, {"name": "a"}], "duplicate tenant"),
        ([{"name": "a", "weight": 0}], "weight"),
        ([{"name": "a", "surprise": 1}], "unknown field"),
        ([{"name": "a", "disruption_budget": -1}], "disruption_budget"),
    ])
    def test_invalid_configs_rejected(self, tenants, needle):
        with pytest.raises(ValidationError) as err:
            tenancy_cfg(tenants)
        assert needle in str(err.value)

    def test_default_tier_must_exist(self):
        with pytest.raises(ValidationError) as err:
            tenancy_cfg([], default_tier="ghost")
        assert "default_tier" in str(err.value)

    def test_empty_tiers_rejected_when_enabled(self):
        with pytest.raises(ValidationError) as err:
            tenancy_cfg([{"name": "a"}], tiers=[])
        assert "tiers" in str(err.value)
        load_operator_config({"tenancy": {"enabled": False, "tiers": []}})

    def test_disabled_default_validates(self):
        assert load_operator_config(None).tenancy.enabled is False


# -- admission bands ----------------------------------------------------------
class TestAdmission:
    def mgr(self, tenants, **kw):
        return TenancyManager(tenancy_cfg(tenants, **kw))

    def test_bands(self):
        m = self.mgr([{"name": "a", "guaranteed": {"cpu": 8.0},
                       "burst": {"cpu": 16.0}}])
        m.queues["a"].usage = np.zeros(1)
        res = ["cpu"]
        assert m.classify("a", np.array([8.0]), res)[0] == ADMIT
        assert m.classify("a", np.array([12.0]), res)[0] == QUEUE
        decision, detail = m.classify("a", np.array([20.0]), res)
        assert decision == SHED
        assert detail["resource"] == "cpu" and detail["limit"] == 16.0

    def test_absent_burst_is_unlimited_absent_guarantee_is_zero(self):
        m = self.mgr([{"name": "a"}])
        m.queues["a"].usage = np.zeros(1)
        assert m.classify("a", np.array([1e9]), ["cpu"])[0] == QUEUE

    def test_ancestor_ceiling_binds_child(self):
        m = self.mgr([
            {"name": "root", "burst": {"cpu": 10.0}},
            {"name": "leaf", "parent": "root", "burst": {"cpu": 100.0}},
        ])
        for q in m.queues.values():
            q.usage = np.zeros(1)
        m.queues["root"].usage[0] = 8.0
        decision, detail = m.classify("leaf", np.array([4.0]), ["cpu"])
        assert decision == SHED and detail["queue"] == "root"

    def test_exempt_tenant_admits(self):
        m = self.mgr([{"name": "a"}])
        assert m.tenant_of("elsewhere", {}) is None
        assert m.classify(None, np.array([1e9]), ["cpu"])[0] == ADMIT

    def test_attribution_label_beats_namespace(self):
        m = self.mgr([{"name": "a"}, {"name": "b"}])
        assert m.tenant_of("b", {constants.LABEL_TENANT: "a"}) == "a"
        assert m.tenant_of("b", {}) == "b"
        assert m.tenant_of("nope", {}) is None

    def test_default_tenant_catches_unmatched(self):
        m = self.mgr([{"name": "shared"}], default_tenant="shared")
        assert m.tenant_of("anything", {}) == "shared"


# -- fairness in the solve paths ---------------------------------------------
class TestFairnessOrdering:
    def one_slot_snap(self):
        # a single node with room for exactly one 2-pod gang
        return solver_cluster(blocks=1, racks=1, hosts=1, cpu=2.0)

    def gangs(self):
        return [solver_gang("a", pods=2, cpu=1.0),
                solver_gang("b", pods=2, cpu=1.0)]

    def test_serial_fairness_breaks_the_tie(self):
        snap = self.one_slot_snap()
        res = solve_serial(snap, self.gangs(), fairness={"a": 0.0, "b": 1.0})
        assert "b" in res.placed and "a" in res.unplaced
        res = solve_serial(snap, self.gangs(), fairness={"a": 1.0, "b": 0.0})
        assert "a" in res.placed and "b" in res.unplaced

    def test_priority_still_dominates_fairness(self):
        gs = self.gangs()
        gs[0].priority = 10.0
        res = solve_serial(self.one_slot_snap(), gs,
                           fairness={"a": 0.0, "b": 100.0})
        assert "a" in res.placed

    def test_engine_fairness_matches_serial(self):
        engine = PlacementEngine(self.one_slot_snap(), device="cpu")
        res = engine.solve(self.gangs(), fairness={"a": 0.0, "b": 1.0})
        assert "b" in res.placed and "a" in res.unplaced

    def test_native_solve_takes_fairness(self):
        from grove_tpu_torch.native import solve_serial_native

        res = solve_serial_native(self.one_slot_snap(), self.gangs(),
                                  fairness={"a": 0.0, "b": 1.0})
        assert "b" in res.placed and "a" in res.unplaced


def test_quota_exceeded_never_preempts():
    assert unsat_preemptible("no feasible domain") is True
    diag = UnsatDiagnosis("over quota", code=UnsatCode.QUOTA)
    assert unsat_code(diag) is UnsatCode.QUOTA
    assert unsat_preemptible(diag) is False


# -- the scheduler-side tenancy cases, in both packages -----------------------
def quota_pair(tenants, nodes=16):
    return Pair({"tenancy": {"enabled": True, "tenants": tenants}},
                nodes=nodes)


def tenant_gang(pair, name, tenant, pods=2, cpu=1.0, namespace="bench"):
    gang, pods_ = odd_gang(name, pods, cpu, required=None,
                           labels={constants.LABEL_TENANT: tenant})
    pair.add(gang, pods_)


def scheduled(plane) -> dict:
    out = {}
    for g in plane.store.scan("PodGang"):
        for c in g.status.conditions:
            if c.type == "Scheduled":
                out[g.metadata.name] = (c.status, c.reason, c.message)
    return out


class TestQuotaShedding:
    def test_shed_carries_quota_exceeded_everywhere(self):
        pair = quota_pair([{"name": "t1", "guaranteed": {"cpu": 2.0},
                            "burst": {"cpu": 4.0}}])
        for i in range(3):
            tenant_gang(pair, f"w{i}", "t1")
        st = pair.settle_and_compare("three gangs, room for two")
        sched = scheduled(pair.t)
        shed = [n for n, c in sched.items() if c[0] == "False"]
        assert len(shed) == 1
        assert sched[shed[0]][1] == "QuotaExceeded"
        assert "over quota" in sched[shed[0]][2]
        m = pair.t.cluster.metrics
        assert m.counter("grove_scheduler_unplaced_total").value(
            reason="QuotaExceeded") >= 1
        assert m.counter("grove_tenant_gangs_shed_total").value(
            tenant="t1") >= 1
        ex = pair.t.cluster.decisions.explain("bench", shed[0])
        rec = ex["records"][-1]
        assert rec["detail"]["code"] == "QuotaExceeded"
        quota = rec["detail"]["funnel"]["quota"]
        assert quota["tenant"] == "t1" and quota["resource"] == "cpu"
        assert st["decisions"]

    def test_shed_gang_readmits_when_usage_drops(self):
        pair = quota_pair([{"name": "t1", "burst": {"cpu": 4.0}}])
        for i in range(3):
            tenant_gang(pair, f"w{i}", "t1")
        pair.settle_and_compare("three gangs, room for two")
        shed = [n for n, c in scheduled(pair.t).items() if c[0] == "False"]
        assert len(shed) == 1
        victim = next(n for n in ("w0", "w1", "w2") if n not in shed)
        pair.both(lambda pl, _cv: pl.delete_gang(victim))
        pair.settle_and_compare("a bound gang leaves")
        retry = pair.j.config.controllers.sync_retry_interval_seconds
        pair.both(lambda pl, _cv: pl.cluster.clock.advance(retry + 0.1))
        pair.settle_and_compare("retry")
        assert all(c[0] == "True" for c in scheduled(pair.t).values())

    def test_queue_band_is_work_conserving(self):
        pair = quota_pair([{"name": "t1"}])
        tenant_gang(pair, "w0", "t1")
        pair.settle_and_compare("burst band")
        assert scheduled(pair.t)["w0"][0] == "True"
        assert pair.t.cluster.metrics.counter(
            "grove_tenant_admissions_total"
        ).value(tenant="t1", decision="queue") >= 1


class TestPodGangTierAdmission:
    def test_empty_priority_class_defaults_to_tenant_tier(self):
        pair = quota_pair([{"name": "t1", "tier": "high"}])
        tenant_gang(pair, "w0", "t1")
        pair.settle_and_compare("tier defaulting")
        g = pair.t.store.get("PodGang", "bench", "w0")
        assert g.spec.priority_class_name == "high"

    def test_unknown_tier_rejected_under_tenancy(self):
        pair = quota_pair([{"name": "t1"}])
        bad = PodGang(metadata=ObjectMeta(name="g", namespace="t1"),
                      spec=PodGangSpec(priority_class_name="platinum"))
        with pytest.raises(ValidationError) as err:
            pair.t.store.create(bad)
        assert "priority_class_name" in str(err.value)

    def test_known_priorityclass_still_legal_under_tenancy(self):
        from grove_tpu_torch.api.auxiliary import PriorityClass

        pair = quota_pair([{"name": "t1"}])
        pair.t.store.create(PriorityClass(
            metadata=ObjectMeta(name="gold", namespace=""), value=500.0))
        pair.t.store.create(PodGang(
            metadata=ObjectMeta(name="g", namespace="t1"),
            spec=PodGangSpec(priority_class_name="gold")))

    def test_any_string_roundtrips_when_tenancy_disabled(self):
        pair = Pair({}, nodes=16)
        pair.t.store.create(PodGang(
            metadata=ObjectMeta(name="g", namespace="default"),
            spec=PodGangSpec(priority_class_name="anything-goes")))
        back = pair.t.store.get("PodGang", "default", "g")
        assert back.spec.priority_class_name == "anything-goes"

    def test_tiers_seeded_as_priority_classes(self):
        pair = quota_pair([{"name": "t1"}])
        classes = {pc.metadata.name: pc
                   for pc in pair.t.store.scan("PriorityClass")}
        assert {"system", "high", "standard", "low"} <= set(classes)
        assert classes["standard"].global_default is True
        assert classes["high"].value > classes["standard"].value
        assert pair.t.store.object_counts() == pair.j.store.object_counts()


def export(p, manager, plane):
    snap = plane.cluster.topology_snapshot()
    manager.refresh_and_export(
        plane.store, snap, plane.cluster.pod_demand_fn(snap.resource_names))


class TestTenantSeriesHygiene:
    def test_removed_tenant_series_are_reconciled_away(self):
        pair = Pair({}, nodes=16)
        out = []
        for p, plane, mgr_cls, load in (
                (JAX, pair.j, jax_tenancy.TenancyManager, jax_load),
                (TORCH, pair.t, TenancyManager, load_operator_config)):
            registry = type(plane.cluster.metrics)()

            def cfg(tenants):
                return load({"tenancy": {"enabled": True,
                                         "tenants": tenants}}).tenancy

            m = mgr_cls(cfg([{"name": "keep", "guaranteed": {"cpu": 4.0}},
                             {"name": "drop", "guaranteed": {"cpu": 4.0}}]),
                        metrics=registry)
            export(p, m, plane)
            share = registry.gauge("grove_tenant_dominant_share")
            assert {ls["tenant"] for ls in share.label_sets()} == {
                "keep", "drop"}
            m.configure(cfg([{"name": "keep", "guaranteed": {"cpu": 4.0}}]))
            export(p, m, plane)
            for name in ("grove_tenant_dominant_share",
                         "grove_tenant_fairness_deficit",
                         "grove_tenant_usage"):
                tenants = {ls["tenant"]
                           for ls in registry.gauge(name).label_sets()}
                assert "drop" not in tenants and "keep" in tenants, name
            out.append(metric_values(registry))
        assert out[0] == out[1]


class TestDRF:
    def test_shares_entitlements_and_error(self):
        pair = quota_pair([{"name": "a", "weight": 3.0},
                           {"name": "b", "weight": 1.0}])
        tenant_gang(pair, "wa", "a")
        tenant_gang(pair, "wb", "b")
        pair.settle_and_compare("two tenants")
        shares = []
        for p, plane in ((JAX, pair.j), (TORCH, pair.t)):
            m = plane.cluster.tenancy
            export(p, m, plane)
            qa, qb = m.queues["a"], m.queues["b"]
            assert qa.dominant_share > 0 and qb.dominant_share > 0
            assert qa.entitlement == pytest.approx(3 * qb.entitlement)
            assert m.fairness_error() >= 0.0
            assert m.debug_state()["tenants"]["a"]["weight"] == 3.0
            shares.append((qa.dominant_share, qb.dominant_share,
                           qa.entitlement, qb.entitlement,
                           m.fairness_error(), m.debug_state()))
        assert shares[0] == shares[1]

    def test_hierarchy_aggregates_usage_upward(self):
        pair = quota_pair([{"name": "root"},
                           {"name": "mid", "parent": "root"},
                           {"name": "leaf", "parent": "mid"}])
        tenant_gang(pair, "w", "leaf")
        pair.settle_and_compare("a leaf tenant's gang")
        usage = []
        for p, plane in ((JAX, pair.j), (TORCH, pair.t)):
            m = plane.cluster.tenancy
            export(p, m, plane)
            leaf = m.queues["leaf"].usage.sum()
            assert leaf > 0
            assert m.queues["mid"].usage.sum() == pytest.approx(leaf)
            assert m.queues["root"].usage.sum() == pytest.approx(leaf)
            usage.append({n: q.usage.tolist() for n, q in m.queues.items()})
        assert usage[0] == usage[1]


def test_admission_decisions_match_the_jax_package():
    """One seeded sequence of classify calls (three queues, a parent
    ceiling, usage moving between calls) gives the same decision and
    detail in both packages."""
    tenants = [
        {"name": "org", "burst": {"cpu": 40.0, "memory": 200.0}},
        {"name": "a", "parent": "org", "guaranteed": {"cpu": 8.0},
         "burst": {"cpu": 24.0}},
        {"name": "b", "parent": "org", "guaranteed": {"memory": 32.0}},
        {"name": "c", "burst": {"cpu": 4.0}},
    ]
    res = ["cpu", "memory"]
    managers = [
        jax_tenancy.TenancyManager(jax_load(
            {"tenancy": {"enabled": True, "tenants": tenants}}).tenancy),
        TenancyManager(tenancy_cfg(tenants)),
    ]
    rng = random.Random(11)
    seen = set()
    for _ in range(300):
        tenant = rng.choice(["org", "a", "b", "c", None])
        demand = np.array([rng.choice([0.0, 2.0, 6.0, 20.0]),
                           rng.choice([0.0, 16.0, 64.0])])
        usage = {n: np.array([rng.uniform(0, 30), rng.uniform(0, 150)])
                 for n in ("org", "a", "b", "c")}
        out = []
        for m in managers:
            for n, u in usage.items():
                m.queues[n].usage = u.copy()
            out.append(m.classify(tenant, demand, res))
        assert out[0] == out[1]
        seen.add(out[1][0])
    assert seen == {ADMIT, QUEUE, SHED}


# -- serving ------------------------------------------------------------------
class TestTrafficTrace:
    def test_diurnal_swing_spans_base_to_peak(self):
        tr = TrafficTrace(base_rps=100.0, peak_rps=1000.0,
                          period_seconds=3600.0, noise=0.0)
        assert tr.demand(0.0) == pytest.approx(100.0)
        assert tr.demand(1800.0) == pytest.approx(1000.0)
        assert tr.demand(3600.0) == pytest.approx(100.0)

    def test_demand_is_a_pure_function_of_time(self):
        a = TrafficTrace(base_rps=50, peak_rps=500, period_seconds=600,
                         noise=0.2, seed=7)
        b = TrafficTrace(base_rps=50, peak_rps=500, period_seconds=600,
                         noise=0.2, seed=7)
        times = [0.0, 17.0, 599.0, 17.0, 301.5, 0.0]
        assert ([a.demand(t) for t in times]
                == [b.demand(t) for t in reversed(times)][::-1])

    def test_noise_draw_depends_on_bucket_not_call_count(self):
        tr = TrafficTrace(base_rps=100, peak_rps=100, noise=0.3, seed=3,
                          sample_seconds=15.0)
        v1 = tr.demand(16.0)
        for _ in range(10):
            tr.demand(500.0)
        assert tr.demand(16.0) == v1
        assert TrafficTrace(base_rps=100, peak_rps=100, noise=0.3, seed=4,
                            sample_seconds=15.0).demand(16.0) != v1

    def test_spikes_multiply_while_active(self):
        tr = TrafficTrace(
            base_rps=100, peak_rps=100, noise=0.0,
            spikes=[SpikeEvent(at_seconds=10, duration_seconds=5,
                               multiplier=3.0)],
        )
        assert tr.demand(9.9) == pytest.approx(100.0)
        assert tr.demand(12.0) == pytest.approx(300.0)
        assert tr.demand(15.0) == pytest.approx(100.0)

    def test_workload_shape_math(self):
        w = WorkloadShape(clique="d", shape="decode", rps_per_replica=50.0,
                          demand_fraction=0.5)
        assert w.utilization(1000.0, 20) == pytest.approx(0.5)
        assert w.utilization(1000.0, 0) == 1.0
        assert w.required_pods(1000.0, 0.7) == 15

    def test_shape_defaults_fill_in(self):
        w = WorkloadShape(clique="p", shape="prefill")
        assert w.rps_per_replica == 25.0
        assert w.demand_fraction == 0.45


class TestPodMetrics:
    def test_staleness_horizon(self):
        pm = PodMetrics(max_age_seconds=30.0)
        pm.report("p", 0.5, now=100.0)
        assert pm.get("p", 120.0) == 0.5
        assert pm.get("p", 131.0) is None
        assert pm.get("ghost", 0.0) is None

    def test_gc_drops_dead_pods(self):
        pm = PodMetrics()
        for i in range(5):
            pm.report(f"p{i}", 0.1, now=0.0)
        assert pm.gc({("default", "p0"), ("default", "p3")}) == 3
        assert len(pm) == 2

    def test_namespaced_pods_do_not_collide(self):
        pm = PodMetrics()
        pm.report("serve-0-w-0", 0.2, now=0.0, namespace="a")
        pm.report("serve-0-w-0", 0.9, now=0.0, namespace="b")
        assert pm.get("serve-0-w-0", 0.0, namespace="a") == 0.2
        assert pm.get("serve-0-w-0", 0.0, namespace="b") == 0.9

    def test_dropout_suppresses_reports(self):
        pm = PodMetrics()
        pm.dropout_steps = 2
        pm.report("p", 0.5, now=0.0)
        assert pm.get("p", 0.0) is None
        assert pm.dropped_total == 1
        pm.tick_dropout()
        pm.tick_dropout()
        pm.report("p", 0.5, now=1.0)
        assert pm.get("p", 1.0) == 0.5


class TestServingConfig:
    def test_enabled_requires_workloads(self):
        with pytest.raises(ValidationError, match="workloads"):
            load_operator_config({"serving": {"enabled": True}})

    def test_bad_trace_rejected(self):
        with pytest.raises(ValidationError) as exc:
            load_operator_config({"serving": {"trace": {
                "base_rps": 100.0, "peak_rps": 50.0, "noise": -1,
                "bogus": 1}}})
        msg = str(exc.value)
        assert "peak_rps" in msg and "noise" in msg and "bogus" in msg

    def test_bad_workload_rejected(self):
        with pytest.raises(ValidationError) as exc:
            load_operator_config({"serving": {"workloads": [
                {"clique": "a", "shape": "nosuch"},
                {"clique": "a", "demand_fraction": 2.0},
                {"shape": "decode"},
            ]}})
        msg = str(exc.value)
        assert "shape" in msg and "duplicate" in msg and "clique" in msg


def test_trace_and_pipeline_match_the_jax_package():
    """One seeded trace with spikes, sampled over a day, and one seeded
    stream of reports, gc passes and dropouts through PodMetrics: equal
    values in both packages."""
    kw = dict(base_rps=80.0, peak_rps=900.0, period_seconds=86400.0,
              noise=0.15, seed=5, sample_seconds=30.0)
    spikes = [(3600.0, 600.0, 2.5), (50000.0, 60.0, 4.0)]
    ours = TrafficTrace(spikes=[SpikeEvent(*s) for s in spikes], **kw)
    ref = jax_serving.TrafficTrace(
        spikes=[jax_serving.SpikeEvent(*s) for s in spikes], **kw)
    times = np.random.default_rng(5).uniform(0.0, 86400.0, 500)
    assert [ours.demand(t) for t in times] == [ref.demand(t) for t in times]
    pms = [PodMetrics(max_age_seconds=45.0),
           jax_serving.PodMetrics(max_age_seconds=45.0)]
    rng = random.Random(5)
    now = 0.0
    for _ in range(400):
        now += rng.uniform(0.0, 10.0)
        op = rng.random()
        name, ns = f"p{rng.randrange(20)}", rng.choice(("a", "b"))
        util = rng.random()
        got = []
        for pm in pms:
            if op < 0.6:
                pm.report(name, util, now, namespace=ns)
            elif op < 0.7:
                pm.dropout_steps = 2
            elif op < 0.8:
                pm.tick_dropout()
            elif op < 0.85:
                got.append(pm.gc({("a", f"p{i}") for i in range(10)}))
            got.append(pm.get(name, now, namespace=ns))
            got.append(pm.debug_state())
        assert got[:len(got) // 2] == got[len(got) // 2:]


def test_kubelet_reports_through_the_traffic_engine():
    """serving.enabled wires a TrafficEngine to the kubelet: ready pods of
    a configured tier report one utilization sample a tick, equal in both
    packages (pods bound by the scheduler, the clique template resolved
    through the PodClique's label)."""
    serving = {"serving": {
        "enabled": True,
        "trace": {"base_rps": 100.0, "peak_rps": 300.0, "noise": 0.1,
                  "seed": 9},
        "workloads": [{"clique": "be", "shape": "decode",
                       "rps_per_replica": 10.0}],
    }}
    pair = Pair(serving, nodes=16)
    api = JAX.api
    clique = api.PodClique(metadata=api.ObjectMeta(
        name="srv-be", namespace="bench",
        labels={JAX.constants.LABEL_CLIQUE_TEMPLATE: "be"}))
    gang, pods = odd_gang("srv", 3, 1.0, required=None)
    for pod in pods:
        pod.metadata.labels[JAX.constants.LABEL_PODCLIQUE] = "srv-be"
    pair.both(lambda pl, cv: pl.create(cv([clique])))
    pair.add(gang, pods)
    pair.settle_and_compare("serving tier bound")
    for _ in range(4):
        pair.both(lambda pl, _cv: pl.cluster.clock.advance(40.0))
        pair.settle_and_compare("tick")
    samples = [dict(pl.cluster.pod_metrics._samples) for pl in (pair.j, pair.t)]
    assert samples[0] == samples[1]
    assert len(samples[1]) == 3
    assert pair.t.cluster.metrics.gauge(
        "grove_serving_demand_rps").value() > 0
