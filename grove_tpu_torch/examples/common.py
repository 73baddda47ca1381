"""Shared runner for the workload-archetype examples.

The counterpart of examples/common.py. Each example mirrors one of the
reference's concept-overview samples
(operator/samples/user-guide/concept-overview/*.yaml) re-expressed
against grove_tpu_torch's API, and runs end-to-end on the simulated
cluster: apply -> reconcile -> gang-schedule -> bound, ready pods. The
placement solves run on the card unless `device="cpu"` is passed (each
example's command line: `--device cpu`).
"""

from __future__ import annotations

import argparse

from ..api.meta import ObjectMeta
from ..api.types import (
    Container,
    PodCliqueSet,
    PodCliqueSetSpec,
    PodCliqueSetTemplateSpec,
    PodCliqueSpec,
    PodCliqueTemplateSpec,
    PodSpec,
)
from ..cluster import make_nodes
from ..controller import Harness
from ..solver.engine import resolve_device


def clique(name: str, replicas: int, cpu: float = 1.0, memory: float = 2.0,
           tpu: float = 0.0, min_available: int | None = None,
           starts_after: tuple[str, ...] = ()) -> PodCliqueTemplateSpec:
    return PodCliqueTemplateSpec(name=name, spec=PodCliqueSpec(
        replicas=replicas,
        min_available=min_available,
        starts_after=list(starts_after),
        pod_spec=PodSpec(containers=[Container(
            name=name, image="inference-engine:latest",
            resources={"cpu": cpu, "memory": memory, "tpu": tpu},
        )]),
    ))


def pcs(name: str, template: PodCliqueSetTemplateSpec,
        replicas: int = 1) -> PodCliqueSet:
    return PodCliqueSet(metadata=ObjectMeta(name=name),
                        spec=PodCliqueSetSpec(replicas=replicas,
                                              template=template))


def run(workload: PodCliqueSet, nodes: int = 32, device=None,
        **harness_kwargs) -> Harness:
    """harness_kwargs pass through (e.g. engine_cls for the remote
    placement-service engine — see operations_tour.py)."""
    h = Harness(
        nodes=make_nodes(nodes, racks_per_block=4, hosts_per_rack=4),
        device=device,
        **harness_kwargs,
    )
    h.apply(workload)
    h.settle()
    return h


def report(h: Harness) -> None:
    print(f"{'POD':42s} {'NODE':10s} READY")
    for pod in h.store.list("Pod"):
        print(f"{pod.metadata.name:42s} {pod.node_name:10s} "
              f"{pod.status.ready}")
    print()
    print(f"{'PODGANG':34s} {'PHASE':10s} SCORE")
    for gang in h.store.list("PodGang"):
        print(f"{gang.metadata.name:34s} {gang.status.phase.value:10s} "
              f"{gang.status.placement_score}")


def parse_device(argv=None, description: str | None = None) -> str:
    """An example's command line: `--device` (default cuda; without
    CUDA it raises unless `--device cpu` is given)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="where the placement solves run: cuda (the card) "
                         "or cpu")
    device = ap.parse_args(argv).device
    resolve_device(device)
    return device
