"""Single-node aggregated serving: one clique of identical replicas, each
pod a complete engine (samples/user-guide/concept-overview/
single-node-aggregated.yaml). Simplest archetype: no gangs-of-gangs, one
base PodGang per PCS replica.

The counterpart of examples/single_node_aggregated.py:
`python -m grove_tpu_torch.examples.single_node_aggregated [--device cpu]`.
"""

from ..api.types import PodCliqueSetTemplateSpec
from .common import clique, parse_device, pcs, report, run


def build():
    return pcs("aggregated", PodCliqueSetTemplateSpec(
        cliques=[clique("engine", replicas=4, cpu=4.0, memory=8.0, tpu=1.0)],
    ))


if __name__ == "__main__":
    report(run(build(),
               device=parse_device(description=__doc__.splitlines()[0])))
