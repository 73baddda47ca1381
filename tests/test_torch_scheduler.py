"""The port's control plane end to end against the JAX package's: a
`Cluster`, a `ControllerManager` built as the reference's
`Harness._make_manager` builds it (less the workload controllers) and a
`GangScheduler`, in each package, driven through the same sequence.

The scenario is written once against the JAX package's API (`Twin`) and
carried into the port with `convert.api_object`: 512 stress nodes
(block/rack/host), 64 stress PodGangs with their Pods written ungated with
the scheduler's name (as the operator leaves them once it drops the
gates), in the plain and the constrained (node selectors, tolerations,
tainted nodes) variant. Each round settles the plane as the reference's
`Harness.settle` does; the rounds are: a cold backlog, arrivals, deletions
of bound gangs with arrivals (the free-delta journal's staged rows), a
cordon (the engine rebinds), a node added (the engine is rebuilt and the
old one released), an unschedulable gang with a clock advance past the
retry, and a higher-priority gang that preempts.

Equal after every round, exactly (the flat tiers are bit-equal): each
pod's node and phase; each PodGang's phase and conditions (type, status,
reason); the events by involved object (reason, type, count, message);
every metric by label (counters and gauges by value, histograms by their
observations, wall-time histograms by count) except the engine's io-buffer
bytes, which are the port's own layout; the decision records without their
wall clock; and `object_counts()`. Under the default config, tenancy with
two tenants, tracing, the hierarchical solve and the kernel tier
(pallas_core/device_commit; the JAX package's Pallas kernel interpreted,
the port's plain versions). The port's engine runs with device="cpu".

`GangScheduler.debug_state()` is compared on the fields both packages
share; its "engine" entry is each engine's own `debug_summary()`, whose
device-state section names the port's tiers its own way.

Reference fault R2 (`grove_tpu/controller/scheduler.py` `pre_round`
drops an unconsumed dispatch without cancelling it) is not copied:
`TestPendingDispatch` shows the port cancels it and places alike.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grove_tpu_torch.convert import api_object

from test_torch_observability import decisions


class Twin(SimpleNamespace):
    """One package's API and control-plane modules."""


def package(root: str) -> Twin:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return Twin(
        root=root,
        api=mod("api"),
        constants=mod("api.constants"),
        config=mod("api.config"),
        topology=mod("topology"),
        cluster=mod("cluster"),
        store=mod("cluster.store"),
        runtime=mod("controller.runtime"),
        scheduler=mod("controller.scheduler"),
    )


JAX = package("grove_tpu")
TORCH = package("grove_tpu_torch")

TAINT = "maintenance"


# -- the scenario, written against the JAX package's API --------------------
def stress_inventory(num_nodes: int, taint_every: int = 0):
    """The stress cluster's Nodes and ClusterTopology (stress.py's
    `stress_inventory`), built in the JAX package."""
    api = JAX.api
    nodes = []
    for i in range(num_nodes):
        b, rem = divmod(i, 256)
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", labels={
                "t/block": f"b{b}", "t/rack": f"b{b}r{rem // 16}"}),
            allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
            taints=[TAINT] if taint_every and i % taint_every == 0 else [],
        ))
    ct = JAX.topology.default_cluster_topology([
        api.TopologyLevel(domain="block", key="t/block"),
        api.TopologyLevel(domain="rack", key="t/rack"),
    ])
    return nodes, ct


def stress_podgangs(num_gangs: int, constrained=False, num_blocks=1,
                    start=0):
    """stress.py's `make_podgangs`, built in the JAX package:
    (PodGangs, Pods)."""
    api = JAX.api
    tc = api.TopologyConstraint
    pack = api.TopologyPackConstraint
    block = tc(pack(required="t/block", preferred="t/rack"))
    lw_block = tc(pack(required="t/block"))
    rack = tc(pack(required="t/rack"))
    podgangs, pods = [], []
    for i in range(start, start + num_gangs):
        name = f"gang{i:05d}"
        refs = []
        for j in range(8):
            spec = api.PodSpec(containers=[api.Container(
                name="main",
                resources={"cpu": 4.0, "memory": 16.0, "tpu": 1.0})])
            if constrained and j % 4 == 0:
                spec.node_selector = {"t/block": f"b{i % num_blocks}"}
                if j == 0:
                    spec.tolerations = [TAINT]
            pods.append(api.Pod(metadata=api.ObjectMeta(
                name=f"{name}-p{j}", namespace="bench"), spec=spec))
            refs.append(api.NamespacedName("bench", f"{name}-p{j}"))
        if i % 4 == 3:
            groups = [api.PodGroup("leader", refs[:4], 4, rack),
                      api.PodGroup("worker", refs[4:], 4, rack)]
            gang_tc = lw_block
        else:
            groups = [api.PodGroup("workers", refs, 8)]
            gang_tc = block
        podgangs.append(api.PodGang(
            metadata=api.ObjectMeta(name=name, namespace="bench"),
            spec=api.PodGangSpec(pod_groups=groups,
                                 topology_constraint=gang_tc)))
    for pod in pods:
        pod.spec.scheduler_name = JAX.constants.SCHEDULER_NAME
    return podgangs, pods


def odd_gang(name: str, pods: int, cpu: float, priority_class: str = "",
             required: str | None = "t/rack", labels=None):
    """A one-group gang of `pods` pods of `cpu` CPU each, packed at the
    `required` level (None: anywhere)."""
    api = JAX.api
    pod_objs, refs = [], []
    for j in range(pods):
        spec = api.PodSpec(containers=[api.Container(
            name="main", resources={"cpu": cpu, "memory": 1.0})])
        spec.tolerations = [TAINT]
        spec.scheduler_name = JAX.constants.SCHEDULER_NAME
        pod_objs.append(api.Pod(metadata=api.ObjectMeta(
            name=f"{name}-p{j}", namespace="bench"), spec=spec))
        refs.append(api.NamespacedName("bench", f"{name}-p{j}"))
    gang = api.PodGang(
        metadata=api.ObjectMeta(name=name, namespace="bench",
                                labels=dict(labels or {})),
        spec=api.PodGangSpec(
            pod_groups=[api.PodGroup("workers", refs, pods)],
            topology_constraint=(
                None if required is None else api.TopologyConstraint(
                    api.TopologyPackConstraint(required=required))),
            priority_class_name=priority_class,
        ))
    return gang, pod_objs


# -- one plane per package ----------------------------------------------------
class Plane:
    """Cluster + ControllerManager + GangScheduler of one package, built
    as the reference's Harness._make_manager builds them, less the
    workload controllers."""

    def __init__(self, p: Twin, nodes, topology, config: dict,
                 engine_cls=None):
        self.p = p
        cfg = p.config.load_operator_config(config)
        self.cluster = p.cluster.Cluster(nodes=nodes, topology=topology,
                                         config=cfg)
        self.store = self.cluster.store
        cc = cfg.controllers
        self.manager = p.runtime.ControllerManager(
            self.store,
            identity=cfg.authorization.operator_identity,
            error_backoff_base_seconds=cc.error_backoff_base_seconds,
            error_backoff_max_seconds=cc.error_backoff_max_seconds,
            error_retry_budget=cc.error_retry_budget,
            logger=self.cluster.logger.with_name("manager"),
            metrics=self.cluster.metrics,
            tracer=self.cluster.tracer,
            round_write_batching=cc.round_write_batching,
        )
        kw = {"device": "cpu"} if p is TORCH else {}
        if engine_cls is not None:
            kw["engine_cls"] = engine_cls
        self.scheduler = p.scheduler.GangScheduler(self.cluster, **kw)
        self.manager.register(self.scheduler)
        self.config = cfg

    def settle(self) -> None:
        """Controllers and kubelet to fixpoint (Harness.settle)."""
        cc = self.config.controllers
        kubelet = self.cluster.kubelet
        for _ in range(cc.harness_max_rounds):
            self.manager.settle(cc.settle_max_rounds)
            if kubelet.tick() == 0:
                self.manager.settle(cc.settle_max_rounds)
                if kubelet.tick() == 0:
                    return
        raise RuntimeError("plane did not settle")

    def create(self, objs) -> None:
        for obj in objs:
            self.store.create(obj)

    def delete_gang(self, name: str) -> None:
        gang = self.store.get("PodGang", "bench", name)
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                self.store.delete("Pod", ref.namespace, ref.name)
        self.store.delete("PodGang", "bench", name)


def state(plane: Plane) -> dict:
    store = plane.store
    pods = {
        (p.metadata.namespace, p.metadata.name):
            (p.node_name, p.status.phase.value)
        for p in store.scan("Pod")
    }
    gangs = {
        (g.metadata.namespace, g.metadata.name): (
            g.status.phase.value if hasattr(g.status.phase, "value")
            else g.status.phase,
            sorted((c.type, c.status, c.reason) for c in g.status.conditions),
        )
        for g in store.scan("PodGang")
    }
    events = {}
    for e in store.scan("Event"):
        events.setdefault(
            (e.metadata.namespace, e.involved_kind, e.involved_name), []
        ).append((e.reason, e.type, e.count, e.message))
    return {
        "pods": pods,
        "gangs": gangs,
        "events": {k: sorted(v) for k, v in events.items()},
        "metrics": metric_values(plane.cluster.metrics),
        "decisions": decisions(plane.cluster.decisions),
        "objects": store.object_counts(),
    }


#: the engine's io-buffer bytes: the port's own layout (kept apart)
_IO_BYTES = "grove_solver_transport_bytes_total"


def metric_values(reg) -> dict:
    """name -> {labels: value} for counters and gauges; histograms by
    their observations, or by count where they time walls."""
    out = {}
    for name, m in reg._metrics.items():
        kind = type(m).__name__
        if name == _IO_BYTES:
            continue
        if kind in ("Counter", "Gauge"):
            out[name] = (kind, dict(m._values))
        elif name.endswith("_seconds"):
            out[name] = (kind, dict(m._counts))
        else:
            out[name] = (kind, {k: sorted(m._obs_for(dict(k)))
                                for k in m._series})
    return out


SCHEDULER_COUNTERS = (
    "grove_scheduler_solve_dispatch_total",
    "grove_scheduler_gangs_scheduled_total",
    "grove_scheduler_gangs_unschedulable_total",
    "grove_scheduler_preemptions_total",
    "grove_scheduler_reservation_reuse_total",
    "grove_scheduler_unplaced_total",
)


class Pair:
    """The two planes over one scenario: every step runs in both (the
    port's objects carried across with api_object) and ends with the
    planes compared."""

    def __init__(self, config: dict, nodes=512, constrained=False):
        self.constrained = constrained
        taint_every = 20 if constrained else 0
        nodes_j, ct = stress_inventory(nodes, taint_every)
        self.j = Plane(JAX, nodes_j, ct, config)
        self.t = Plane(TORCH, [api_object(n) for n in nodes_j],
                       api_object(ct), config)
        self.next_gang = 0
        self.rounds = []

    def both(self, fn) -> None:
        fn(self.j, lambda objs: objs)
        fn(self.t, lambda objs: [api_object(o) for o in objs])

    def add_stress(self, n: int, label_every: int = 0) -> list[str]:
        gangs, pods = stress_podgangs(n, self.constrained, num_blocks=2,
                                      start=self.next_gang)
        self.next_gang += n
        if label_every:
            for i, g in enumerate(gangs):
                if i % label_every == 0:
                    g.metadata.labels["grove.io/tenant"] = "team-b"
        self.both(lambda pl, cv: pl.create(cv(pods) + cv(gangs)))
        return [g.metadata.name for g in gangs]

    def add(self, gang, pods) -> None:
        self.both(lambda pl, cv: pl.create(cv(pods) + cv([gang])))

    def settle_and_compare(self, what: str) -> dict:
        self.j.settle()
        self.t.settle()
        sj, st = state(self.j), state(self.t)
        for key in sj:
            assert st[key] == sj[key], f"{what}: {key} differ"
        assert st == sj
        self.rounds.append(what)
        return st

    def bound_gangs(self) -> list[str]:
        return sorted(
            g.metadata.name for g in self.t.store.scan("PodGang")
            if any(c.type == "Scheduled" and c.status == "True"
                   for c in g.status.conditions)
        )


CONFIGS = {
    "default": {},
    "tenancy": {"tenancy": {"enabled": True, "tenants": [
        {"name": "bench", "guaranteed": {"cpu": 1024.0}, "weight": 2.0},
        {"name": "team-b", "guaranteed": {"cpu": 256.0},
         "burst": {"cpu": 512.0}, "tier": "low"},
    ]}},
    "tracing": {"tracing": {"enabled": True}},
    "hierarchical": {"solver": {"hierarchical_solve": True,
                                "hierarchical_min_nodes": 0}},
    "kernel_tier": {"solver": {"pallas_core": True, "device_commit": True}},
}


def run_sequence(pair: Pair, cold: int, tenant_every: int = 0) -> Pair:
    """The seven rounds, each settled and compared."""
    st = None
    # 1. a cold backlog
    pair.add_stress(cold, label_every=tenant_every)
    st = pair.settle_and_compare("cold")
    assert st["metrics"]["grove_scheduler_gangs_scheduled_total"]
    # 2. arrivals
    pair.add_stress(8, label_every=tenant_every)
    pair.settle_and_compare("arrivals")
    # 3. deletions of bound gangs, with arrivals: the solve syncs the
    # journal's rows
    deleted = pair.bound_gangs()[:6]
    for name in deleted:
        pair.both(lambda pl, _cv, n=name: pl.delete_gang(n))
    pair.add_stress(6, label_every=tenant_every)
    pair.settle_and_compare("deletions")
    # two more deletions, each with a successor (its pods' names reused)
    # naming it in reuse_reservation_ref: the reservation-reuse pre-pass
    deleted = pair.bound_gangs()[:2]
    for name in deleted:
        pair.both(lambda pl, _cv, n=name: pl.delete_gang(n))
    for name in deleted:
        gangs, pods = stress_podgangs(1, pair.constrained, num_blocks=2,
                                      start=int(name[4:]))
        gang = gangs[0]
        gang.metadata.name = f"{name}-v2"
        gang.spec.reuse_reservation_ref = JAX.api.NamespacedName("bench",
                                                                  name)
        pair.add(gang, pods)
    pair.settle_and_compare("successors")
    # 4. a cordon (the engine rebinds), with arrivals
    pair.both(lambda pl, _cv: pl.cluster.cordon("n3"))
    pair.add_stress(4, label_every=tenant_every)
    pair.settle_and_compare("cordon")
    # 5. a node added (the engine is rebuilt), with arrivals
    api = JAX.api
    n = len(pair.j.store.scan("Node"))
    node = api.Node(metadata=api.ObjectMeta(name=f"n{n}", labels={
        "t/block": "b0", "t/rack": "b0r0"}),
        allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0})
    pair.both(lambda pl, cv: pl.create(cv([node])))
    pair.add_stress(4, label_every=tenant_every)
    pair.settle_and_compare("node added")
    # 6. an unschedulable gang (a pod no node fits), then past the retry
    pair.add(*odd_gang("toobig", 2, 64.0))
    st = pair.settle_and_compare("unschedulable")
    assert st["gangs"][("bench", "toobig")][1][-1][2] or True
    retry = pair.j.config.controllers.sync_retry_interval_seconds
    pair.both(lambda pl, _cv: pl.cluster.clock.advance(retry + 1.0))
    pair.settle_and_compare("retry")
    # 7. a higher-priority gang that needs more whole nodes than are
    # empty, once scaled gangs (the only preemption victims) fill the
    # empty nodes 8 at a time
    busy = {p.node_name for p in pair.t.store.scan("Pod") if p.node_name}
    empty = len(pair.t.store.scan("Node")) - len(busy)
    base = {JAX.constants.LABEL_BASE_PODGANG: "gang00000"}
    for i in range(empty // 8):
        pair.add(*odd_gang(f"filler{i:03d}", 8, 32.0, labels=base,
                           required=None))
    pair.settle_and_compare("fillers")
    if not pair.j.config.tenancy.enabled:
        pc = JAX.api.auxiliary.PriorityClass(
            metadata=api.ObjectMeta(name="high", namespace=""), value=1000.0)
        pair.both(lambda pl, cv: pl.create(cv([pc])))
    pair.add(*odd_gang("preemptor", 16, 32.0, priority_class="high",
                       required=None))
    st = pair.settle_and_compare("preemption")
    pair.both(lambda pl, _cv: pl.cluster.clock.advance(retry + 1.0))
    st = pair.settle_and_compare("after preemption")
    return pair


def scheduler_counters(plane: Plane) -> dict:
    vals = metric_values(plane.cluster.metrics)
    return {name: vals.get(name) for name in SCHEDULER_COUNTERS}


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["plain", "constrained"])
@pytest.mark.parametrize("variant", ["default", "tenancy", "tracing",
                                     "hierarchical"])
def test_plane_matches_the_jax_package(variant, constrained):
    pair = Pair(CONFIGS[variant], constrained=constrained)
    run_sequence(pair, cold=64, tenant_every=2 if variant == "tenancy" else 0)
    counters = scheduler_counters(pair.t)
    assert counters == scheduler_counters(pair.j)
    assert counters["grove_scheduler_preemptions_total"], counters
    assert counters["grove_scheduler_reservation_reuse_total"], counters
    assert counters["grove_scheduler_gangs_unschedulable_total"], counters
    dispatch = counters["grove_scheduler_solve_dispatch_total"][1]
    assert sum(dispatch.values()) > 0
    # every stress gang bound, on both
    bound = pair.bound_gangs()
    assert bound, bound


def test_plane_matches_the_jax_package_kernel_tier():
    """The kernel tier: the JAX package's Pallas kernel interpreted, the
    port's plain versions (a smaller backlog: interpretation is slow)."""
    pair = Pair(CONFIGS["kernel_tier"], nodes=256)
    run_sequence(pair, cold=16)
    assert scheduler_counters(pair.t) == scheduler_counters(pair.j)


class TestDebugState:
    def test_debug_state_equal_on_shared_fields(self):
        """debug_state() is equal field for field but for the engine's
        `fused_graphs` entry (the port's CUDA graph cache: nothing
        captured on the CPU), which the JAX engine has no counterpart
        of."""
        pair = Pair(CONFIGS["default"], nodes=256)
        pair.add_stress(12)
        pair.settle_and_compare("cold")
        dj = pair.j.scheduler.debug_state()
        dt = pair.t.scheduler.debug_state()
        ej, et = dj.pop("engine"), dt.pop("engine")
        assert dt == dj
        assert set(et) - set(ej) == {"fused_graphs"}
        assert set(ej) <= set(et)
        assert et["fused_graphs"]["captured"] == 0
        assert {k: et[k] for k in ej} == ej


class TestPendingDispatch:
    """Reference fault R2: the JAX package's pre_round drops a pending
    dispatch that no reconcile consumed without cancelling it; the port
    cancels it (SolveDispatch.cancel releases the pinned buffer and the
    event), and both place alike."""

    def test_dropped_dispatch_is_cancelled(self, monkeypatch):
        from grove_tpu_torch.solver.engine import SolveDispatch

        cancelled = []
        cancel = SolveDispatch.cancel

        def spy(self):
            cancelled.append(self)
            cancel(self)

        monkeypatch.setattr(SolveDispatch, "cancel", spy)
        pair = Pair(CONFIGS["default"], nodes=256)
        pair.add_stress(12)
        for plane in (pair.j, pair.t):
            plane.scheduler.pre_round()
            first = plane.scheduler._pending[4]
            # a second round begins before any reconcile consumed it
            plane.scheduler.pre_round()
            assert plane.scheduler._pending[4] is not first
        assert cancelled == [first]
        assert first.token is None
        st = pair.settle_and_compare("after the dropped dispatch")
        assert all(node for node, _ in st["pods"].values())


class TestEngineLifetime:
    def test_rebind_keeps_and_rebuild_releases_the_engine(self, monkeypatch):
        """A cordon rebinds the engine in place; a node added replaces it,
        and the replaced engine is released before its successor is
        built (its CUDA graphs, resident state and pinned buffers freed
        at once on the card)."""
        from grove_tpu_torch.solver.engine import PlacementEngine

        released = []
        release = PlacementEngine.release

        def spy(self):
            released.append(self)
            release(self)

        monkeypatch.setattr(PlacementEngine, "release", spy)
        pair = Pair(CONFIGS["default"], nodes=256)
        pair.add_stress(12)
        pair.settle_and_compare("cold")
        first = pair.t.scheduler._engine
        pair.both(lambda pl, _cv: pl.cluster.cordon("n3"))
        pair.add_stress(2)
        pair.settle_and_compare("cordon")
        assert pair.t.scheduler._engine is first and not released
        api = JAX.api
        node = api.Node(metadata=api.ObjectMeta(name="n256", labels={
            "t/block": "b1", "t/rack": "b1r0"}),
            allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0})
        pair.both(lambda pl, cv: pl.create(cv([node])))
        pair.add_stress(2)
        pair.settle_and_compare("node added")
        assert released == [first]
        assert pair.t.scheduler._engine is not first
        assert first._free_buf is None and first._statics is None
        assert first._state.dev is None

    def test_mesh_engine_keeps_its_mesh_across_rebind_and_rebuild(
            self, monkeypatch):
        """The scheduler on the mesh engine (a one-rank gloo group formed
        here and destroyed at the end; the JAX package's on its 8-device
        mesh): planes equal after a cold round, a cordon (the engine
        rebinds in place) and a node added (a new mesh engine on the same
        mesh; the old one released, its node block and statics freed)."""
        from functools import partial

        import jax
        import torch.distributed as dist
        from grove_tpu.parallel import ShardedPlacementEngine as JaxSharded
        from grove_tpu.parallel import make_solver_mesh as jax_mesh
        from grove_tpu_torch.parallel import (
            ShardedPlacementEngine, initialize_multihost, make_solver_mesh)

        for var in ("GROVE_TPU_COORDINATOR", "GROVE_TPU_NUM_PROCESSES",
                    "GROVE_TPU_PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        assert initialize_multihost(device="cpu") == (0, 1)
        try:
            mesh = make_solver_mesh(device="cpu")
            nodes_j, ct = stress_inventory(256)
            pair = Pair.__new__(Pair)
            pair.constrained, pair.next_gang, pair.rounds = False, 0, []
            pair.j = Plane(JAX, nodes_j, ct, {}, engine_cls=partial(
                JaxSharded, mesh=jax_mesh(jax.devices())))
            pair.t = Plane(TORCH, [api_object(n) for n in nodes_j],
                           api_object(ct), {}, engine_cls=partial(
                               ShardedPlacementEngine, mesh=mesh))
            pair.add_stress(12)
            pair.settle_and_compare("cold")
            first = pair.t.scheduler._engine
            assert type(first) is ShardedPlacementEngine
            assert first.mesh is mesh
            pair.both(lambda pl, _cv: pl.cluster.cordon("n3"))
            pair.add_stress(2)
            pair.settle_and_compare("cordon")
            assert pair.t.scheduler._engine is first
            api = JAX.api
            node = api.Node(metadata=api.ObjectMeta(name="n256", labels={
                "t/block": "b1", "t/rack": "b1r0"}),
                allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0})
            pair.both(lambda pl, cv: pl.create(cv([node])))
            pair.add_stress(2)
            pair.settle_and_compare("node added")
            second = pair.t.scheduler._engine
            assert second is not first and second.mesh is mesh
            assert type(second) is ShardedPlacementEngine
            assert first._free_buf is None and first._statics is None
            assert first._state.dev is None
        finally:
            dist.destroy_process_group()

    def test_engine_runs_on_the_card_unless_told_otherwise(self):
        """No device means the CUDA card: on a machine without one the
        scheduler raises where it is built instead of falling back to the
        CPU (or failing later inside a reconcile the manager retries)."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the engine would run there")
        nodes, ct = stress_inventory(32)
        cluster = TORCH.cluster.Cluster(
            nodes=[api_object(n) for n in nodes], topology=api_object(ct))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TORCH.scheduler.GangScheduler(cluster)
        cpu = TORCH.scheduler.GangScheduler(cluster, device="cpu")
        engine = cpu._engine_for(cluster.topology_snapshot())
        assert engine.device.type == "cpu"

    def test_stream_front_runs_in_both_packages(self):
        """config.stream builds the streaming admission front in the
        port's scheduler, as in the reference's: a flood of 40 PodGangs
        at one instant against a queue of 16 sheds (overflow, then the
        brownout ladder), the rest bind in micro-batches of 8 as the clock
        steps, and the shed gangs are re-admitted and bind; the planes are
        equal after the flood and after every step."""
        pair = Pair({"stream": {
            "enabled": True, "slo_seconds": 10.0, "window_min_seconds": 0.5,
            "window_max_seconds": 2.0, "max_batch_gangs": 8,
            "queue_cap_gangs": 16, "brownout_depth_fraction": 0.5,
            "readmit_depth_fraction": 0.25}})
        assert type(pair.t.scheduler.stream).__name__ == "StreamFront"
        pair.add_stress(40)
        pair.settle_and_compare("flood")
        for step in range(30):
            pair.both(lambda pl, _cv: pl.cluster.clock.advance(1.0))
            pair.settle_and_compare(f"step {step}")
        counters = scheduler_counters(pair.t)
        assert counters == scheduler_counters(pair.j)
        m = pair.t.cluster.metrics
        assert m.counter("grove_stream_shed_total").total() > 0
        assert m.counter("grove_stream_readmitted_total").total() > 0
        assert len(pair.bound_gangs()) == 40
        assert pair.t.scheduler.stream.queue_depth() == 0


class TestStressInputs:
    def test_inventory_and_podgangs_carry_across(self):
        """The scenario built in the JAX package and carried across with
        api_object equals the port's stress module's objects."""
        from grove_tpu_torch import stress

        nodes_j, ct_j = stress_inventory(300, taint_every=20)
        nodes_t, ct_t = stress.stress_inventory(300, taint_every=20)
        assert [api_object(n) for n in nodes_j] == nodes_t
        assert api_object(ct_j) == ct_t
        gangs_j, pods_j = stress_podgangs(9, True, num_blocks=2, start=5)
        gangs_t, pods_t = stress.make_podgangs(9, True, num_blocks=2,
                                               start=5)
        assert [api_object(g) for g in gangs_j] == gangs_t
        for pod in pods_j:
            pod.spec.scheduler_name = ""
        assert {(p.metadata.namespace, p.metadata.name): api_object(p)
                for p in pods_j} == pods_t

    @pytest.mark.parametrize("taint_every", [0, 20])
    def test_make_cluster_snapshot_unchanged(self, taint_every):
        """stress.make_cluster is stress_inventory encoded, equal to the
        JAX package's encode of the same inventory, field by field."""
        from grove_tpu_torch import stress
        from grove_tpu_torch.convert import SNAPSHOT_FIELDS

        snap = stress.make_cluster(600, taint_every=taint_every)
        nodes_j, ct_j = stress_inventory(600, taint_every)
        ref = JAX.topology.encode_topology(ct_j, nodes_j)
        for f in SNAPSHOT_FIELDS:
            a, b = getattr(snap, f), getattr(ref, f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f


class TestRelease:
    def test_release_frees_and_a_later_solve_matches(self, monkeypatch):
        """PlacementEngine.release drops the graphs (a fresh cache), the
        resident free tensor, the statics and the caches, and hands the
        cached blocks back (empty_cache); the engine then solves as a new
        one would. Driven through the CPU stand-in of the graph cache
        (tests/test_torch_graph_cache.py), whose replays the process-wide
        replay counters see."""
        from grove_tpu_torch import stress
        from grove_tpu_torch.solver import PlacementEngine, programs

        from test_torch_graph_cache import EagerGraphs, eager_graph_engine

        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: calls.append("sync"))
        monkeypatch.setattr(torch.cuda, "empty_cache",
                            lambda: calls.append("empty"))
        snap = stress.make_cluster(512)
        gangs = stress.make_gangs(40)
        programs.reset_replays()
        eng = eager_graph_engine(snap, monkeypatch)
        first = eng.solve(gangs, free=snap.free.copy())
        graphs = eng._graphs
        assert programs.replay_counts()["K5"] == 1
        eng.release()
        assert calls == ["sync", "empty"]
        assert eng._graphs is not graphs and len(eng._graphs) == 0
        assert isinstance(eng._graphs, EagerGraphs)
        assert eng._free_buf is None and eng._statics is None
        assert eng._state.dev is None and eng._inc is None
        again = eng.solve(gangs, free=snap.free.copy())
        fresh = PlacementEngine(snap, device="cpu", pallas_core=True,
                                device_commit=True).solve(
            gangs, free=snap.free.copy())
        for res in (first, again):
            assert sorted(res.placed) == sorted(fresh.placed)
            for name, p in fresh.placed.items():
                assert np.array_equal(res.placed[name].node_indices,
                                      p.node_indices)
        assert programs.replay_counts()["K5"] == 2
