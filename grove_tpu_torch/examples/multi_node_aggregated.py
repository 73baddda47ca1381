"""Multi-node aggregated serving: one model instance spans a leader and
worker pods (multi-node-aggregated.yaml); the instance is a scaling
group, so adding capacity means whole new leader+workers gangs that
schedule all-or-nothing and pack a rack.

The counterpart of examples/multi_node_aggregated.py:
`python -m grove_tpu_torch.examples.multi_node_aggregated [--device cpu]`.
"""

from ..api.types import (
    PodCliqueScalingGroupConfig,
    PodCliqueSetTemplateSpec,
    TopologyConstraintSpec,
    TopologyPackConstraintSpec,
)
from .common import clique, parse_device, pcs, report, run


def build():
    return pcs("multinode", PodCliqueSetTemplateSpec(
        cliques=[
            clique("leader", replicas=1, cpu=2.0, memory=4.0),
            clique("worker", replicas=4, cpu=4.0, memory=8.0, tpu=2.0),
        ],
        pod_clique_scaling_group_configs=[PodCliqueScalingGroupConfig(
            name="instance", clique_names=["leader", "worker"],
            replicas=2, min_available=1,
            topology_constraint=TopologyConstraintSpec(
                pack_constraint=TopologyPackConstraintSpec(preferred="rack"),
            ),
        )],
    ))


if __name__ == "__main__":
    report(run(build(),
               device=parse_device(description=__doc__.splitlines()[0])))
