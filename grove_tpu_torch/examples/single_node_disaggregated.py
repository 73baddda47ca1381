"""Single-node disaggregated serving: prefill and decode as separate
cliques behind a frontend, decode only starting after prefill
(single-node-disaggregated.yaml). One base gang carries all three
roles — they schedule all-or-nothing.

The counterpart of examples/single_node_disaggregated.py:
`python -m grove_tpu_torch.examples.single_node_disaggregated [--device cpu]`.
"""

from ..api.types import CliqueStartupType, PodCliqueSetTemplateSpec
from .common import clique, parse_device, pcs, report, run


def build():
    return pcs("disagg", PodCliqueSetTemplateSpec(
        startup_type=CliqueStartupType.EXPLICIT,
        cliques=[
            clique("frontend", replicas=1, cpu=0.5, memory=1.0),
            clique("prefill", replicas=2, cpu=4.0, memory=8.0, tpu=1.0),
            clique("decode", replicas=2, cpu=4.0, memory=8.0, tpu=1.0,
                   starts_after=("prefill",)),
        ],
    ))


if __name__ == "__main__":
    report(run(build(),
               device=parse_device(description=__doc__.splitlines()[0])))
