"""Operations tour: node disruptions (drain + failure-domain outage), then
the placement SERVICE (the operator/external-scheduler process split) with
live TLS rotation and both introspection surfaces.

Covers the ops features the other examples don't touch:
  - gang-aware node drain and rack-outage recovery (the NodeMonitor;
    docs/operations.md "Node disruptions") — runs fully in-process
  - grove-placement-service with self-managed TLS (CertRotator +
    RotatingTLSServer hot restart; docs/operations.md)
  - RemotePlacementEngine injected as the scheduler's engine
  - harness.debug_dump() and the grove.Placement/Debug health probe

The counterpart of examples/operations_tour.py:
`python -m grove_tpu_torch.examples.operations_tour [--device cpu]`. Every
harness of the tour, and the placement service's engines, run on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import re
import socket
from functools import partial

from ..api.types import PodCliqueSetTemplateSpec
from .common import clique, parse_device, pcs, report, run


#: the milestone text that differs between two runs of the tour: the
#: reconcile p99 walls and the journal's byte count on disk
MILESTONE_MASKS = (
    (re.compile(r"p99=[0-9.]+ms"), "p99=<wall>"),
    (re.compile(r"\d+ bytes on disk"), "<bytes> on disk"),
)


def milestones(out: str) -> list[str]:
    """The tour's printed lines, each with MILESTONE_MASKS applied: what
    two runs of the tour must print alike."""
    lines = []
    for line in out.splitlines():
        for pattern, mask in MILESTONE_MASKS:
            line = pattern.sub(mask, line)
        lines.append(line)
    return lines


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def node_lifecycle_tour(device=None) -> None:
    """Executable doc for the node-lifecycle subsystem: a maintenance
    drain that respects each clique's MinAvailable, then a whole-rack
    outage that the control plane detects, grace-evicts and repairs onto
    healthy domains. Pure in-process — no service dependencies."""
    from ..api.types import Node, node_ready
    from ..cluster.inventory import RACK_KEY

    workload = pcs("node-tour", PodCliqueSetTemplateSpec(cliques=[
        clique("workers", replicas=6, cpu=1.0),
    ]))
    # short lifecycle windows so the tour's virtual-clock advances stay
    # readable (production defaults: 40s lease / 300s grace / 60s stable)
    harness = run(workload, nodes=8, device=device, config={"cluster": {
        "node_lease_duration_seconds": 10.0,
        "pod_eviction_grace_seconds": 20.0,
        "node_stable_ready_seconds": 15.0,
    }})
    cluster = harness.cluster

    def placements():
        return sorted(
            (p.metadata.name, p.node_name)
            for p in harness.store.list("Pod")
        )

    # 1. gang-aware drain: cordon + paced eviction, never dipping the
    # clique below MinAvailable by more than the one pod in flight
    target = placements()[0][1]
    print(f"\nnode lifecycle: draining {target} "
          f"({sum(1 for _, n in placements() if n == target)} pods on it)")
    cluster.drain(target)
    for _ in range(30):
        harness.advance(6.0)
        if cluster.node_drained(target):
            break
    assert cluster.node_drained(target), "drain did not complete"
    evicted = cluster.metrics.counter(
        "grove_node_drain_evictions_total"
    ).total()
    print(f"  drained: {int(evicted)} paced evictions, every pod "
          "re-placed and Ready elsewhere")
    cluster.uncordon(target)

    # 2. failure-domain outage: one rack goes NotReady in one tick; after
    # the eviction grace its pods are swept and repaired onto healthy
    # racks; the rack rides the stable-ready window back in
    rack_of = {
        n.metadata.name: n.metadata.labels[RACK_KEY]
        for n in harness.store.list(Node.KIND)
    }
    victim_rack = rack_of[placements()[0][1]]
    failed = cluster.fail_domain(RACK_KEY, victim_rack)
    harness.settle()
    print(f"  rack outage: {victim_rack} -> nodes {failed} NotReady")
    harness.advance(25.0)  # past pod_eviction_grace_seconds
    survivors = {rack_of[n] for _, n in placements()}
    assert victim_rack not in survivors, survivors
    print(f"  repaired onto healthy racks: {sorted(survivors)}")
    cluster.recover_domain(RACK_KEY, victim_rack)
    harness.advance(1.0)    # first post-recovery heartbeat
    harness.advance(16.0)   # stable-ready window elapses
    back = [
        n.metadata.name
        for n in harness.store.list(Node.KIND)
        if rack_of[n.metadata.name] == victim_rack and node_ready(n)
    ]
    assert sorted(back) == sorted(failed)
    print(f"  rack recovered: {back} Ready again "
          "(after the stable-ready window)")
    dump = harness.debug_dump()
    print(f"  node lifecycle debug: {dump['node_lifecycle']}")


def cold_restart_tour(device=None) -> None:
    """Executable doc for the durable state store (docs/operations.md
    "Cold restart & disaster recovery"): run the control plane with a
    write-ahead-logged store, kill the whole process state at steady
    state, and recover from disk — replay, soft-state rebuild, and the
    same fixpoint. Pure in-process — no service dependencies."""
    import tempfile

    from ..chaos.harness import settled_fingerprint
    from ..cluster.store import ObjectStore

    workload = pcs("restart-tour", PodCliqueSetTemplateSpec(cliques=[
        clique("router", replicas=1, cpu=0.5),
        clique("workers", replicas=4, cpu=1.0),
    ]))
    with tempfile.TemporaryDirectory(prefix="grove-tour-wal-") as wal_dir:
        # 1. a durable control plane: every committed store mutation is
        # WAL-appended; snapshots cut on cadence and bound replay
        harness = run(workload, nodes=8, device=device, config={
            "durability": {"wal_dir": wal_dir, "fsync": "never"},
        })
        fixpoint = settled_fingerprint(harness.store)
        wal = harness.cluster.durability.debug_state()
        print(f"\ncold restart: steady state journaled — "
              f"{wal['wal_records_total']} WAL records, "
              f"{wal['wal_bytes_total']} bytes on disk")

        # 2. the disk image alone rebuilds a bit-identical store (what a
        # standalone inspection/repair tool would do)
        recovered = ObjectStore.recover(wal_dir)
        assert settled_fingerprint(recovered) == fixpoint
        print(f"  standalone ObjectStore.recover: "
              f"{recovered.recovery_stats['wal_records_replayed']} records "
              f"replayed -> bit-identical store "
              f"(outcome={recovered.recovery_stats['outcome']})")

        # 3. the full cold restart: drop the live store, recover from
        # disk, re-derive ALL soft state (leases expired, manager +
        # scheduler + kubelet caches rebuilt), settle to the same fixpoint
        stats = harness.cold_restart()
        harness.settle()
        assert settled_fingerprint(harness.store) == fixpoint
        print(f"  harness.cold_restart: outcome={stats['outcome']}, "
              f"replayed {stats['wal_records_replayed']} records, "
              "re-settled to the identical fixpoint")

        # 4. the restarted plane is fully live: new work schedules
        harness.apply(pcs("post-restart", PodCliqueSetTemplateSpec(
            cliques=[clique("w", replicas=2, cpu=0.5)],
        )))
        harness.settle()
        bound = sum(1 for p in harness.store.list("Pod") if p.node_name)
        dump = harness.debug_dump()["store"]["durability"]
        print(f"  post-restart workload bound ({bound} pods total); "
              f"recovery checkpoint at seq {dump['last_snapshot_seq']}")

        # 5. disaster recovery: the crashed process is GONE — a brand-new
        # one boots from the files alone and resumes journaling
        from ..controller import Harness

        fixpoint = settled_fingerprint(harness.store)
        harness.cluster.durability.close()
        fresh = Harness.recover({"durability": {"wal_dir": wal_dir,
                                                "fsync": "never"}},
                                device=device)
        fresh.settle()
        assert settled_fingerprint(fresh.store) == fixpoint
        print("  Harness.recover: a NEW process booted from the files "
              "alone and reached the identical fixpoint")


def main(argv=None) -> None:
    device = parse_device(argv, description=__doc__.splitlines()[0])
    node_lifecycle_tour(device)
    cold_restart_tour(device)
    try:
        from ..service import (
            CertRotator,
            PlacementService,
            RemotePlacementEngine,
            RotatingTLSServer,
        )
        from ..service.tls import make_ca
    except ImportError as exc:
        # the service stack needs grpcio + cryptography; the node
        # lifecycle tour above is dependency-free and already ran
        print(f"\nservice tour skipped (missing optional dependency: "
              f"{exc.name})")
        return
    # 1. the long-lived placement service, TLS from a self-managed CA
    ca_cert, ca_key = make_ca()
    rotator = CertRotator(ca_cert, ca_key, hostname="127.0.0.1")
    address = f"127.0.0.1:{_free_port()}"
    server = RotatingTLSServer(address, rotator,
                               service=PlacementService(device=device))
    server.start()
    try:
        # 2. the control plane, solving THROUGH the service boundary
        workload = pcs("ops-tour", PodCliqueSetTemplateSpec(cliques=[
            clique("router", replicas=1, cpu=0.5),
            clique("workers", replicas=4, cpu=1.0),
        ]))
        harness = run(
            workload,
            nodes=8,
            device=device,
            engine_cls=partial(
                RemotePlacementEngine, address=address,
                root_ca=rotator.bundle.ca_cert,
            ),
        )
        report(harness)

        # 3. introspection: the in-process dump ...
        dump = harness.debug_dump()
        mgr = dump["manager"]["controllers"]
        print("\nintrospection (harness.debug_dump):")
        for name, stats in sorted(mgr.items()):
            print(f"  {name:<24} reconciles={int(stats['reconciles']):>4} "
                  f"p99={stats['duration_seconds']['p99'] * 1000:.1f}ms")
        print(f"  store objects: {dump['store']['objects_by_kind']}")

        # ... and the service's Debug RPC (the health probe)
        import grpc

        creds = grpc.ssl_channel_credentials(
            root_certificates=rotator.bundle.ca_cert
        )
        with grpc.secure_channel(address, creds) as ch:
            svc = json.loads(
                ch.unary_unary("/grove.Placement/Debug")(b"", timeout=10.0)
            )
        print(f"\nservice Debug probe: epochs={list(svc['epochs'])} "
              f"solves={svc['solves_total']}")

        # 4. live certificate rotation: re-issue under the same CA and
        # hot-restart the listener; the next solve reconnects on its own
        import datetime

        # widen the renewal window past the cert's whole validity: renewal
        # is immediately due (the public knob; tests inject now_fn instead)
        rotator.renew_before = datetime.timedelta(
            days=rotator.valid_days + 1
        )
        assert server.maybe_rotate(), "rotation was due"
        harness.apply(pcs("after-rotation", PodCliqueSetTemplateSpec(
            cliques=[clique("w", replicas=2, cpu=0.5)],
        )))
        harness.settle()
        print("\nsolved a new workload through the ROTATED listener "
              f"(rotations={rotator.rotations})")
    finally:
        server.stop(grace=None)


if __name__ == "__main__":
    main()
