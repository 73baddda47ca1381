"""The port's simulated cluster: object store, kubelet, node leases,
`Cluster`, controller runtime and slow-start batching, against the JAX
package's.

- tests/test_cluster.py's cases, on the port. The three that drove a
  `Harness` (the workload controllers are not ported yet) drive the
  port's ControllerManager and GangScheduler over PodGangs instead:
  slow start under a failing Pod admission, the manager's compaction of
  drained events, and the incremental usage against a full scan.
- One seeded sequence of creates, updates, status writes, binds,
  finalizers and deletes through both packages' ObjectStores: equal event
  streams (type, kind, key, resource_version), `object_counts()` and
  `last_seq`.
- The C `clone`/`shallow` of the native store (built with g++ at the
  first import of `cluster.store`) against the Python versions on every
  API kind the store holds.
- Kubelet runs and node-lease renewals over clock advances, a failed
  heartbeat and a lost node, equal in both packages.
"""

from __future__ import annotations

import importlib
import random
import subprocess
import sys
from pathlib import Path

import pytest

from grove_tpu_torch.api import constants
from grove_tpu_torch.api.meta import ObjectMeta, OwnerReference
from grove_tpu_torch.api.types import Container, Pod, PodPhase, PodSpec
from grove_tpu_torch.cluster import Cluster, make_nodes
from grove_tpu_torch.cluster.store import AlreadyExists, NotFound
from grove_tpu_torch.convert import api_object

from test_cluster import simple_pcs as jax_simple_pcs
from test_torch_scheduler import JAX, TORCH, Pair, Plane, odd_gang, stress_inventory

ROOT = Path(__file__).resolve().parents[1]


def simple_pcs(name="web", replicas=1):
    return api_object(jax_simple_pcs(name, replicas))


def make_pod(name, node="", gates=(), wait_for="", pclq=""):
    labels = {constants.LABEL_PODCLIQUE: pclq} if pclq else {}
    ann = {constants.ANNOTATION_WAIT_FOR: wait_for} if wait_for else {}
    pod = Pod(
        metadata=ObjectMeta(name=name, labels=labels, annotations=ann),
        spec=PodSpec(
            containers=[Container(name="c", resources={"cpu": 1.0})],
            scheduling_gates=list(gates),
        ),
    )
    pod.node_name = node
    return pod


class TestStore:
    def test_create_get_versioning(self):
        c = Cluster(nodes=make_nodes(4))
        pcs = c.store.create(simple_pcs())
        assert pcs.metadata.uid and pcs.metadata.generation == 1
        assert pcs.spec.template.termination_delay == 4 * 3600
        with pytest.raises(AlreadyExists):
            c.store.create(simple_pcs())

    def test_admission_rejects_invalid(self):
        from grove_tpu_torch.api import ValidationError

        c = Cluster()
        bad = simple_pcs()
        bad.spec.template.cliques = []
        with pytest.raises(ValidationError):
            c.store.create(bad)
        assert c.store.get("PodCliqueSet", "default", "web") is None

    def test_generation_bumps_only_on_spec_change(self):
        c = Cluster()
        pcs = c.store.create(simple_pcs())
        pcs.metadata.labels["x"] = "y"
        pcs = c.store.update(pcs)
        assert pcs.metadata.generation == 1
        pcs.spec.replicas = 3
        pcs = c.store.update(pcs)
        assert pcs.metadata.generation == 2
        pcs.status.replicas = 3
        c.store.update_status(pcs)
        pcs = c.store.get("PodCliqueSet", "default", "web")
        assert pcs.metadata.generation == 2
        assert pcs.status.replicas == 3

    def test_finalizer_gated_delete(self):
        c = Cluster()
        c.store.create(simple_pcs())
        c.store.add_finalizer("PodCliqueSet", "default", "web",
                              constants.FINALIZER_PCS)
        c.store.delete("PodCliqueSet", "default", "web")
        obj = c.store.get("PodCliqueSet", "default", "web")
        assert obj is not None and obj.metadata.deletion_timestamp is not None
        c.store.remove_finalizer("PodCliqueSet", "default", "web",
                                 constants.FINALIZER_PCS)
        assert c.store.get("PodCliqueSet", "default", "web") is None
        types = [e.type for e in c.store.events_since(0)
                 if e.kind == "PodCliqueSet"]
        assert types[-1] == "Deleted"

    def test_orphan_collection(self):
        c = Cluster()
        owner = c.store.create(simple_pcs())
        pod = make_pod("p1")
        pod.metadata.owner_references = [
            OwnerReference(kind="PodCliqueSet", name="web",
                           uid=owner.metadata.uid)
        ]
        c.store.create(pod)
        assert c.store.collect_orphans() == 0
        c.store.delete("PodCliqueSet", "default", "web")
        assert c.store.collect_orphans() == 1
        assert c.store.get(Pod.KIND, "default", "p1") is None

    def test_events_since(self):
        c = Cluster()
        seq0 = c.store.last_seq
        c.store.create(simple_pcs())
        evs = c.store.events_since(seq0)
        assert [e.type for e in evs] == ["Added"]
        assert c.store.events_since(c.store.last_seq) == []

    def test_not_found(self):
        c = Cluster()
        with pytest.raises(NotFound):
            c.store.delete("Pod", "default", "nope")

    def test_durable_recovery_round_trips(self, tmp_path):
        """The durable store (ROADMAP item 8b, refused until it was
        ported): a cluster journals, `ObjectStore.recover` and
        `recover_in_place` rebuild its store from the files, an empty
        directory and a cluster without a journal refuse as the
        reference's do."""
        from grove_tpu_torch.api.config import load_operator_config
        from grove_tpu_torch.cluster.durability import DurabilityError
        from grove_tpu_torch.cluster.store import ObjectStore

        (tmp_path / "empty").mkdir()
        with pytest.raises(DurabilityError, match="no durable state"):
            ObjectStore.recover(str(tmp_path / "empty"))
        with pytest.raises(RuntimeError, match="durability"):
            Cluster().cold_restart()
        wal = str(tmp_path / "wal")
        c = Cluster(nodes=make_nodes(2), config=load_operator_config(
            {"durability": {"wal_dir": wal, "fsync": "never"}}))
        c.store.create(make_pod("p", node="node-0"))
        back = ObjectStore.recover(wal)
        assert back.recovery_stats["outcome"] == "clean"
        assert back.last_seq == c.store.last_seq
        assert back.get(Pod.KIND, "default", "p") == \
            c.store.get(Pod.KIND, "default", "p")
        again = ObjectStore()
        assert again.recover_in_place(wal)["outcome"] == "clean"
        assert again.object_counts() == c.store.object_counts()


class TestKubelet:
    def test_gated_pod_stays_pending(self):
        c = Cluster(nodes=make_nodes(2))
        c.store.create(make_pod("p", node="node-0",
                                gates=[constants.PODGANG_PENDING_CREATION_GATE]))
        c.kubelet.run_to_quiesce()
        assert c.store.get(Pod.KIND, "default", "p").status.phase == PodPhase.PENDING

    def test_bound_pod_runs_and_readies(self):
        c = Cluster(nodes=make_nodes(2))
        c.store.create(make_pod("p", node="node-0"))
        c.kubelet.run_to_quiesce()
        pod = c.store.get(Pod.KIND, "default", "p")
        assert pod.status.phase == PodPhase.RUNNING
        assert pod.status.ready and pod.status.ever_started

    def test_startup_barrier(self):
        c = Cluster(nodes=make_nodes(2))
        c.store.create(make_pod("leader-0", node="node-0", pclq="leader"))
        c.store.create(make_pod("worker-0", node="node-1", pclq="worker",
                                wait_for="leader:1"))
        c.kubelet.tick()
        assert not c.store.get(Pod.KIND, "default", "worker-0").status.ready
        c.kubelet.run_to_quiesce()
        leader = c.store.get(Pod.KIND, "default", "leader-0")
        worker = c.store.get(Pod.KIND, "default", "worker-0")
        assert leader.status.ready and worker.status.ready

    def test_malformed_wait_for_is_unsatisfiable_not_fatal(self):
        from grove_tpu_torch.cluster.kubelet import parse_wait_for
        from grove_tpu_torch.observability.events import (
            REASON_INVALID_STARTUP_BARRIER,
        )

        with pytest.raises(ValueError):
            parse_wait_for("leader:not-a-number")
        with pytest.raises(ValueError):
            parse_wait_for("no-colon-at-all")
        c = Cluster(nodes=make_nodes(2))
        c.store.create(make_pod("ok", node="node-0", pclq="leader"))
        c.store.create(make_pod("bad", node="node-1", pclq="worker",
                                wait_for="leader:not-a-number"))
        c.kubelet.run_to_quiesce()
        assert c.store.get(Pod.KIND, "default", "ok").status.ready
        bad = c.store.get(Pod.KIND, "default", "bad")
        assert bad.status.phase == PodPhase.RUNNING
        assert not bad.status.ready
        events = [e for e in c.store.list("Event")
                  if e.reason == REASON_INVALID_STARTUP_BARRIER]
        assert len(events) == 1 and events[0].type == "Warning"
        assert "leader:not-a-number" in events[0].message
        count0 = events[0].count
        c.kubelet.tick()
        c.kubelet.tick()
        events = [e for e in c.store.list("Event")
                  if e.reason == REASON_INVALID_STARTUP_BARRIER]
        assert events[0].count == count0
        pod = c.store.get(Pod.KIND, "default", "bad")
        pod.metadata.annotations[constants.ANNOTATION_WAIT_FOR] = "leader:1"
        c.store.update(pod)
        c.kubelet.run_to_quiesce()
        assert c.store.get(Pod.KIND, "default", "bad").status.ready

    def test_crash_recover_and_evict(self):
        c = Cluster(nodes=make_nodes(1))
        c.store.create(make_pod("p", node="node-0"))
        c.kubelet.run_to_quiesce()
        c.kubelet.crash_pod("default", "p")
        pod = c.store.get(Pod.KIND, "default", "p")
        assert pod.status.phase == PodPhase.RUNNING
        assert not pod.status.ready and pod.status.restart_count == 1
        c.kubelet.run_to_quiesce()
        assert not c.store.get(Pod.KIND, "default", "p").status.ready
        c.kubelet.recover_pod("default", "p")
        c.kubelet.run_to_quiesce()
        assert c.store.get(Pod.KIND, "default", "p").status.ready
        c.kubelet.evict_pod("default", "p")
        assert c.store.get(Pod.KIND, "default", "p").status.phase == PodPhase.FAILED


class TestClusterFacade:
    def test_snapshot_with_usage_and_cordon(self):
        c = Cluster(nodes=make_nodes(8, racks_per_block=2, hosts_per_rack=2))
        c.store.create(make_pod("p", node="node-0"))
        c.kubelet.run_to_quiesce()
        c.cordon("node-1")
        snap = c.topology_snapshot()
        assert snap.num_nodes == 8
        ci = snap.resource_names.index("cpu")
        assert snap.free[0, ci] == snap.capacity[0, ci] - 1.0
        assert not snap.schedulable[1]
        assert snap.num_levels == 3

    def test_pod_demand_fn(self):
        c = Cluster(nodes=make_nodes(1))
        c.store.create(make_pod("p"))
        fn = c.pod_demand_fn(["cpu", "memory", "tpu"])
        assert list(fn("default", "p")) == [1.0, 0.0, 0.0]
        assert fn("default", "missing") is None


class TestLiveTopology:
    def test_topology_snapshot_follows_store_update(self):
        from grove_tpu_torch.api.types import (
            ClusterTopology, TopologyLevel, sort_topology_levels,
        )

        nodes = make_nodes(4, racks_per_block=2, hosts_per_rack=2)
        for n in nodes:
            n.metadata.labels["t/zone"] = "z0"
        c = Cluster(nodes=nodes)
        assert "t/zone" not in c.topology_snapshot().level_keys
        ct = c.store.get(ClusterTopology.KIND, c.topology.metadata.namespace,
                         c.topology.metadata.name)
        ct.spec.levels = sort_topology_levels(
            ct.spec.levels + [TopologyLevel(domain="zone", key="t/zone")]
        )
        c.store.update(ct)
        snap = c.topology_snapshot()
        assert "t/zone" in snap.level_keys
        assert snap.domains_at(snap.level_index("t/zone")) == 1


class TestManagerErrorBound:
    def test_permanently_failing_reconciler_bounded_errors(self):
        from grove_tpu_torch.cluster.store import ObjectStore
        from grove_tpu_torch.controller.runtime import (
            ControllerManager, Request,
        )

        class Broken:
            name = "broken"

            def map_event(self, event):
                return []

            def reconcile(self, request):
                raise RuntimeError("boom")

        mgr = ControllerManager(ObjectStore())
        mgr.register(Broken())
        for _ in range(500):
            mgr._enqueue("broken", Request("default", "x"))
            mgr.run_once()
        assert len(mgr.errors) <= 2 * mgr.max_errors_per_key + 64
        assert all(c == "broken" for c, _, _ in mgr.errors)


class TestSlowStartBatching:
    def test_batches_grow_exponentially(self):
        from grove_tpu_torch.controller.concurrency import run_with_slow_start

        calls = []
        tasks = [(f"t{i}", lambda i=i: calls.append(i)) for i in range(11)]
        result = run_with_slow_start(tasks)
        assert calls == list(range(11))
        assert len(result.succeeded) == 11
        assert not result.has_errors and not result.skipped

    def test_halts_after_failing_batch_and_skips_rest(self):
        from grove_tpu_torch.controller.concurrency import run_with_slow_start

        calls = []

        def ok(i):
            calls.append(i)

        def boom(i):
            calls.append(i)
            raise RuntimeError("apiserver down")

        tasks = [(f"t{i}", (lambda i=i: boom(i)) if i == 4 else
                  (lambda i=i: ok(i))) for i in range(11)]
        result = run_with_slow_start(tasks)
        assert calls == [0, 1, 2, 3, 4, 5, 6]
        assert [n for n, _ in result.errors] == ["t4"]
        assert result.skipped == ["t7", "t8", "t9", "t10"]

    def test_failing_pod_admission_sees_one_probe_create(self):
        """Slow-start pod creates against a Pod admission that rejects
        everything: one probe create, the rest skipped; once admission
        recovers the creates go through and the scheduler binds them."""
        from grove_tpu_torch.api.validation import ValidationError
        from grove_tpu_torch.cluster.store import Admission
        from grove_tpu_torch.controller.concurrency import run_with_slow_start

        nodes, ct = stress_inventory(16)
        pl = Plane(TORCH, [api_object(n) for n in nodes], api_object(ct), {})
        attempts = []

        def reject(pod):
            attempts.append(pod.metadata.name)
            raise ValidationError(["pod quota exhausted"])

        pl.store.register_admission("Pod", Admission(validate=reject))
        gang, pods = odd_gang("w", 8, 1.0)
        pods = [api_object(p) for p in pods]
        result = run_with_slow_start(
            [(p.metadata.name, lambda p=p: pl.store.create(p)) for p in pods])
        assert attempts == ["w-p0"]
        assert len(result.skipped) == 7
        assert not pl.store.scan(Pod.KIND)
        pl.store.register_admission("Pod", Admission())
        result = run_with_slow_start(
            [(p.metadata.name, lambda p=p: pl.store.create(p)) for p in pods])
        assert not result.has_errors
        pl.create([api_object(gang)])
        pl.settle()
        assert all(p.node_name and p.status.ready
                   for p in pl.store.scan(Pod.KIND))


class TestEventCompaction:
    def test_compaction_and_resume_contract(self):
        from grove_tpu_torch.cluster.store import StoreError

        c = Cluster()
        c.store.create(simple_pcs())
        mid = c.store.last_seq
        c.store.create(simple_pcs(name="web2"))
        last = c.store.last_seq
        assert c.store.compact_events(mid) > 0
        assert c.store.last_seq == last
        assert all(e.seq > mid for e in c.store.events_since(mid))
        with pytest.raises(StoreError):
            c.store.events_since(0)

    def test_manager_compacts_only_drained_events(self):
        pl = scheduler_plane(16)
        gang, pods = odd_gang("first", 2, 1.0)
        pl.create([api_object(p) for p in pods] + [api_object(gang)])
        pl.settle()
        assert pl.manager.compact_processed_events() > 0
        gang, pods = odd_gang("second", 2, 1.0)
        pl.create([api_object(p) for p in pods] + [api_object(gang)])
        pl.settle()
        assert all(p.node_name and p.status.ready
                   for p in pl.store.scan(Pod.KIND))
        assert pl.manager.compact_processed_events() > 0
        assert len(pl.store._events) == 0


def scheduler_plane(nodes: int) -> Plane:
    nodes_j, ct = stress_inventory(nodes)
    return Plane(TORCH, [api_object(n) for n in nodes_j], api_object(ct), {})


def test_incremental_usage_matches_full_scan():
    """usage() is maintained incrementally off the watch log; after binds,
    an eviction, a delete and a compaction-forced rebuild it matches a
    from-scratch accounting scan."""

    def scratch(cluster):
        out = {}
        for pod in cluster.store.scan(Pod.KIND):
            if not cluster._counted(pod):
                continue
            per_node = out.setdefault(pod.node_name, {})
            for res, amount in pod.spec.total_requests().items():
                per_node[res] = per_node.get(res, 0.0) + amount
        return out

    def assert_match(cluster):
        inc, full = cluster.usage(), scratch(cluster)
        for n in set(inc) | set(full):
            a, b = inc.get(n, {}), full.get(n, {})
            for res in set(a) | set(b):
                assert a.get(res, 0.0) == pytest.approx(
                    b.get(res, 0.0), abs=1e-9), (n, res)

    pl = scheduler_plane(16)
    gang, pods = odd_gang("w", 4, 2.0)
    pl.create([api_object(p) for p in pods] + [api_object(gang)])
    pl.settle()
    assert_match(pl.cluster)
    assert pl.cluster.usage()
    pl.cluster.kubelet.evict_pod("bench", "w-p0")
    pl.settle()
    assert_match(pl.cluster)
    pl.store.delete(Pod.KIND, "bench", "w-p1")
    pl.settle()
    assert_match(pl.cluster)
    pl.manager.compact_processed_events()
    pl.store.compact_events(pl.store.last_seq)
    assert_match(pl.cluster)
    gang, pods = odd_gang("second", 2, 1.0)
    pl.create([api_object(p) for p in pods] + [api_object(gang)])
    pl.settle()
    assert_match(pl.cluster)


# -- both packages' stores over one seeded sequence ---------------------------
def store_sequence(p, seed: int):
    """A seeded mix of writes through package `p`'s ObjectStore; returns
    the store."""
    api = p.api
    store = p.store.ObjectStore(p.cluster.SimClock())
    rng = random.Random(seed)
    names = [f"p{i}" for i in range(24)]
    live: set[str] = set()
    for step in range(400):
        op = rng.random()
        name = rng.choice(names)
        store.clock.advance(rng.choice((0.0, 0.5)))
        try:
            if name not in live or op < 0.2:
                pod = api.Pod(
                    metadata=api.ObjectMeta(
                        name=name, namespace=rng.choice(("a", "b")),
                        labels={"k": str(rng.randrange(3))}),
                    spec=api.PodSpec(containers=[api.Container(
                        name="c", resources={"cpu": float(rng.randrange(4))})]))
                store.create(pod)
                live.add(name)
                continue
            ns = next(n for n in ("a", "b")
                      if store.peek("Pod", n, name) is not None)
            if op < 0.4:
                pod = store.get("Pod", ns, name)
                pod.metadata.labels["k"] = str(rng.randrange(3))
                if rng.random() < 0.5:
                    pod.spec.containers[0].resources["cpu"] += 1.0
                store.update(pod)
            elif op < 0.55:
                pod = store.get("Pod", ns, name)
                pod.status.phase = rng.choice(list(type(pod.status.phase)))
                store.update_status(pod)
            elif op < 0.65:
                store.bind_pod(ns, name, f"node-{rng.randrange(4)}")
            elif op < 0.72:
                store.add_finalizer("Pod", ns, name, "f")
            elif op < 0.78:
                store.remove_finalizer("Pod", ns, name, "f")
            else:
                store.delete("Pod", ns, name)
                if store.peek("Pod", ns, name) is None:
                    live.discard(name)
        except p.store.StoreError:
            pass
        except StopIteration:
            live.discard(name)
    return store


def event_stream(store):
    return [(e.seq, e.type, e.kind, e.namespace, e.name,
             e.obj.metadata.resource_version) for e in store.events_since(0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_sequence_matches_the_jax_package(seed):
    ours, ref = store_sequence(TORCH, seed), store_sequence(JAX, seed)
    assert event_stream(ours) == event_stream(ref)
    assert ours.object_counts() == ref.object_counts()
    assert ours.last_seq == ref.last_seq
    assert len(event_stream(ours)) > 100


# -- the native store --------------------------------------------------------
def store_objects():
    """One object of every kind the store holds, from a settled plane (and
    the kinds the plane does not write, built with their fields set)."""
    from grove_tpu_torch.api import auxiliary

    pair = Pair({}, nodes=64)
    pair.add_stress(4)
    pair.settle_and_compare("sample")
    store = pair.t.store
    objs = {}
    for kind in ("Node", "Pod", "PodGang", "ClusterTopology",
                 "PriorityClass", "Event", "Lease"):
        objs[kind] = store.scan(kind)[0]
    objs["PodCliqueSet"] = simple_pcs()
    pcs = api_object(jax_simple_pcs())
    from grove_tpu_torch.api.types import PodClique, PodCliqueScalingGroup

    objs["PodClique"] = PodClique(
        metadata=ObjectMeta(name="c", labels={"a": "b"}),
        spec=pcs.spec.template.cliques[0].spec)
    objs["PodCliqueScalingGroup"] = PodCliqueScalingGroup(
        metadata=ObjectMeta(name="sg"))
    for cls in (auxiliary.Service, auxiliary.ServiceAccount, auxiliary.Role,
                auxiliary.RoleBinding, auxiliary.Secret,
                auxiliary.HorizontalPodAutoscaler):
        objs[cls.KIND] = cls(metadata=ObjectMeta(
            name="x", annotations={"k": "v"},
            owner_references=[OwnerReference(kind="K", name="o", uid="u")]))
    return objs


def test_native_store_is_active():
    from grove_tpu_torch.cluster import store

    assert store.NATIVE_STORE_ACTIVE


def test_native_clone_and_shallow_equal_the_python_versions():
    from grove_tpu_torch.cluster import store

    objs = store_objects()
    assert len(objs) == 16
    for kind, obj in objs.items():
        cls = type(obj)
        native, python = store.clone(obj), store._make_cloner(cls)(obj)
        assert native == python == obj, kind
        assert native is not obj and type(native) is cls
        assert native.metadata is not obj.metadata
        assert native.metadata.labels is not obj.metadata.labels
        native.metadata.labels["mutated"] = "1"
        assert "mutated" not in obj.metadata.labels, kind
        for shallow in (store._shallow(obj), store._make_shallower(cls)(obj)):
            assert shallow == obj and shallow is not obj
            assert shallow.metadata is obj.metadata, kind


def test_native_store_kill_switch():
    """GROVE_TPU_NO_NATIVE_STORE=1 keeps the Python versions, which clone
    alike."""
    code = (
        "import os; os.environ['GROVE_TPU_NO_NATIVE_STORE'] = '1'\n"
        "from grove_tpu_torch.cluster import store\n"
        "assert not store.NATIVE_STORE_ACTIVE\n"
        "from grove_tpu_torch.api.meta import ObjectMeta\n"
        "from grove_tpu_torch.api.types import Container, Pod, PodSpec\n"
        "p = Pod(metadata=ObjectMeta(name='p', labels={'a': 'b'}),\n"
        "        spec=PodSpec(containers=[Container(name='c')]))\n"
        "c = store.clone(p)\n"
        "assert c == p and c.metadata.labels is not p.metadata.labels\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr


# -- kubelet and node leases in both packages ---------------------------------
def kubelet_run(p):
    nodes = [api_object(n) if p is TORCH else n
             for n in JAX.cluster.make_nodes(6, racks_per_block=2,
                                             hosts_per_rack=3)]
    c = p.cluster.Cluster(nodes=nodes)
    api = p.api
    for i in range(10):
        pod = api.Pod(
            metadata=api.ObjectMeta(name=f"p{i}", labels=(
                {p.constants.LABEL_PODCLIQUE: "leader" if i < 2 else "w"})),
            spec=api.PodSpec(containers=[api.Container(
                name="c", resources={"cpu": 1.0})]))
        if i >= 2:
            pod.metadata.annotations[p.constants.ANNOTATION_WAIT_FOR] = "leader:2"
        pod.node_name = f"node-{i % 6}"
        c.store.create(pod)
    nodehealth = importlib.import_module(f"{p.root}.cluster.nodehealth")
    trace = []
    for step in range(12):
        changes = c.kubelet.tick()
        if step == 3:
            c.kubelet.fail_heartbeat("node-2")
        if step == 5:
            c.kubelet.crash_pod("default", "p4")
        if step == 7:
            c.store.delete("Node", "default", "node-5")
            c.kubelet.restore_heartbeat("node-2")
        if step == 8:
            c.kubelet.recover_pod("default", "p4")
        trace.append((
            changes,
            sorted(nodehealth.node_lease_renew_times(c.store).items()),
            sorted((q.metadata.name, q.status.phase.value, q.status.ready,
                    q.status.restart_count) for q in c.store.scan("Pod")),
        ))
        c.clock.advance(2.5)
    events = sorted((e.involved_name, e.reason, e.count)
                    for e in c.store.scan("Event"))
    return trace, events, c.store.object_counts(), c.store.last_seq


def test_kubelet_and_node_leases_match_the_jax_package():
    ours, ref = kubelet_run(TORCH), kubelet_run(JAX)
    assert ours == ref
    trace = ours[0]
    # leases renew per clock instant; node-2's stops while it fails
    renew = dict(trace[5][1])
    assert renew["node-2"] < renew["node-0"]
    assert any(ready for _, _, ready, _ in trace[-1][2])
