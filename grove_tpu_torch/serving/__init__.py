"""Elastic serving: traffic-driven multi-level autoscaling.

The serving loop, end to end (ROADMAP item 4; SURVEY §2a/§5 — the
reference ships scale subresources + HPA on all three CRDs and
`ReuseReservationRef`, and delegates the rest to kube machinery):

  TrafficTrace (diurnal curve + seeded noise + spikes, a pure function
  of the virtual clock)
    -> WorkloadShape (prefill / decode / router demand split)
    -> SimKubelet reports per-pod utilization each tick
    -> PodMetrics aggregation (metrics-server stand-in, staleness + GC)
    -> Autoscaler HPA sync on the config cadence
    -> scale subresource write
    -> PCS/PCSG reconcilers create/delete scaled PodGangs
    -> scheduler places scale-ups against the vacating gang's own
       reservation (reuse_reservation_ref: near-free, topology-stable)

The counterpart of grove_tpu/serving/. `Cluster` always builds the
PodMetrics aggregator and, when config.serving.enabled, the TrafficEngine
the kubelet reports through; the autoscaler and the workload controllers
that close the loop arrive with ROADMAP item 6b-ii.
"""

from .pipeline import PodMetrics, TrafficEngine
from .traffic import (
    DEFAULT_SHAPES,
    SpikeEvent,
    TrafficTrace,
    WorkloadShape,
)

__all__ = [
    "DEFAULT_SHAPES",
    "PodMetrics",
    "SpikeEvent",
    "TrafficEngine",
    "TrafficTrace",
    "WorkloadShape",
]
