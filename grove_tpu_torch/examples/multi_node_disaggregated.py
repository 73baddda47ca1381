"""Multi-node disaggregated serving (multi-node-disaggregated.yaml): the
full Grove shape — prefill and decode each a leader/worker scaling
group, scaled independently. The base gang carries each group's
min_available replicas; further replicas are scaled gangs that never
block the base system.

The counterpart of examples/multi_node_disaggregated.py:
`python -m grove_tpu_torch.examples.multi_node_disaggregated [--device cpu]`.
"""

from ..api.types import (
    PodCliqueScalingGroupConfig,
    PodCliqueSetTemplateSpec,
)
from .common import clique, parse_device, pcs, report, run


def build():
    return pcs("mn-disagg", PodCliqueSetTemplateSpec(
        cliques=[
            clique("pleader", replicas=1, cpu=2.0, memory=4.0),
            clique("pworker", replicas=4, cpu=4.0, memory=8.0, tpu=2.0),
            clique("dleader", replicas=1, cpu=2.0, memory=4.0),
            clique("dworker", replicas=4, cpu=4.0, memory=8.0, tpu=2.0),
        ],
        pod_clique_scaling_group_configs=[
            PodCliqueScalingGroupConfig(
                name="prefill", clique_names=["pleader", "pworker"],
                replicas=2, min_available=1),
            PodCliqueScalingGroupConfig(
                name="decode", clique_names=["dleader", "dworker"],
                replicas=1, min_available=1),
        ],
    ))


if __name__ == "__main__":
    report(run(build(), nodes=64,
               device=parse_device(description=__doc__.splitlines()[0])))
