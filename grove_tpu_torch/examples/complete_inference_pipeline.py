"""The complete pipeline (complete-inference-pipeline.yaml): single-node
components (frontend, vision encoder) + multi-node disaggregated LLM
prefill/decode groups + explicit startup ordering, in one PodCliqueSet.

The counterpart of examples/complete_inference_pipeline.py:
`python -m grove_tpu_torch.examples.complete_inference_pipeline [--device cpu]`.
"""

from ..api.types import (
    CliqueStartupType,
    PodCliqueScalingGroupConfig,
    PodCliqueSetTemplateSpec,
)
from .common import clique, parse_device, pcs, report, run


def build():
    return pcs("pipeline", PodCliqueSetTemplateSpec(
        startup_type=CliqueStartupType.EXPLICIT,
        cliques=[
            clique("frontend", replicas=2, cpu=0.5, memory=1.0),
            clique("vision-encoder", replicas=1, cpu=2.0, memory=4.0,
                   tpu=1.0),
            clique("pleader", replicas=1, cpu=2.0, memory=4.0),
            clique("pworker", replicas=2, cpu=4.0, memory=8.0, tpu=2.0),
            clique("dleader", replicas=1, cpu=2.0, memory=4.0,
                   starts_after=("pleader",)),
            clique("dworker", replicas=2, cpu=4.0, memory=8.0, tpu=2.0,
                   starts_after=("pleader",)),
        ],
        pod_clique_scaling_group_configs=[
            PodCliqueScalingGroupConfig(
                name="prefill", clique_names=["pleader", "pworker"],
                replicas=2, min_available=1),
            PodCliqueScalingGroupConfig(
                name="decode", clique_names=["dleader", "dworker"],
                replicas=2, min_available=1),
        ],
    ))


if __name__ == "__main__":
    report(run(build(), nodes=64,
               device=parse_device(description=__doc__.splitlines()[0])))
