"""Deterministic virtual-time traffic model for elastic serving.

The north star is sustained traffic from millions of users: offered load
swings ~10x over a day (the diurnal curve every consumer-facing serving
fleet sees), with short spikes riding on top. This module models that as
a pure function of the VIRTUAL clock so every consumer — the kubelet's
metrics reporting, the autoscaler's sync sweeps, the diurnal bench, the
chaos driver — sees one consistent, bit-reproducible demand stream:

  TrafficTrace.demand(t) =
      diurnal(t)                      base..peak cosine over the period
    * (1 + noise * N(0, 1)[bucket])   seeded PER TIME BUCKET, so the draw
                                      depends only on t — never on how
                                      many times or in what order demand()
                                      was called (chaos replay safety)
    * prod(spike multipliers active at t)

WorkloadShape maps the cluster-level demand onto per-clique utilization —
the reference's disaggregated serving use cases (prefill-heavy compute,
decode-heavy memory-bound, lightweight router; README.md:38-44) each take
a share of the stream and saturate at a different per-replica capacity.
The utilization a pod reports is

  demand * demand_fraction / (ready_replicas * rps_per_replica)

which is exactly the metrics-server signal the k8s HPA algorithm divides
by its target: deployed capacity at target utilization serves
rps_per_replica * target RPS per pod.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field


@dataclass(slots=True)
class SpikeEvent:
    """A transient load spike: demand multiplies by `multiplier` for
    `duration_seconds` starting at virtual time `at_seconds`."""

    at_seconds: float = 0.0
    duration_seconds: float = 60.0
    multiplier: float = 2.0

    def active(self, t: float) -> bool:
        return self.at_seconds <= t < self.at_seconds + self.duration_seconds


@dataclass
class TrafficTrace:
    """Seeded diurnal demand curve (requests/sec as a function of the
    virtual clock). base..peak sweep over `period_seconds` with the peak
    at `peak_at_fraction` of the period; `noise` is the per-bucket
    multiplicative stddev; `spikes` are scheduled events (chaos injects
    additional ones at runtime via TrafficEngine, kept separate so they
    can be removed at disarm)."""

    base_rps: float = 100.0
    peak_rps: float = 1000.0
    period_seconds: float = 86400.0
    peak_at_fraction: float = 0.5
    noise: float = 0.0
    seed: int = 0
    #: noise resolution: one independent draw per bucket of this many
    #: virtual seconds
    sample_seconds: float = 15.0
    spikes: list[SpikeEvent] = field(default_factory=list)

    @classmethod
    def from_config(cls, data: dict) -> "TrafficTrace":
        """Build from the validated serving.trace config mapping (spikes
        decoded from {at_seconds, duration_seconds, multiplier} dicts)."""
        kw = dict(data)
        kw["spikes"] = [SpikeEvent(**s) for s in kw.get("spikes", [])]
        return cls(**kw)

    def diurnal(self, t: float) -> float:
        """The noise-free, spike-free curve: cosine between base and peak
        (trough at phase 0, peak at peak_at_fraction of the period)."""
        phase = 2.0 * math.pi * (
            (t / self.period_seconds) - self.peak_at_fraction
        )
        return self.base_rps + (self.peak_rps - self.base_rps) * 0.5 * (
            1.0 + math.cos(phase)
        )

    def _noise_factor(self, t: float) -> float:
        if self.noise <= 0:
            return 1.0
        bucket = int(t // max(self.sample_seconds, 1e-9))
        # a string seed hashes process-independently (sha512), and the
        # draw is a pure function of (seed, bucket): replaying a chaos
        # seed — or calling demand() twice for the same tick — can never
        # shift the stream
        rng = random.Random(f"grove-traffic-{self.seed}-{bucket}")
        return max(0.0, 1.0 + self.noise * rng.gauss(0.0, 1.0))

    def demand(self, t: float, extra_spikes: tuple = ()) -> float:
        """Offered load at virtual time t (requests/sec)."""
        level = self.diurnal(t) * self._noise_factor(t)
        for spike in self.spikes:
            if spike.active(t):
                level *= spike.multiplier
        for spike in extra_spikes:
            if spike.active(t):
                level *= spike.multiplier
        return level


#: the reference's disaggregated serving roles, as default capacity
#: shapes: prefill is compute-bound (few RPS per replica), decode is
#: memory-bound (moderate), the router is a lightweight fan-out tier.
#: rps_per_replica here is per POD of the clique; config entries may
#: override either number per workload.
DEFAULT_SHAPES: dict[str, dict[str, float]] = {
    "prefill": {"rps_per_replica": 25.0, "demand_fraction": 0.45},
    "decode": {"rps_per_replica": 50.0, "demand_fraction": 0.45},
    "router": {"rps_per_replica": 400.0, "demand_fraction": 0.10},
}


@dataclass(slots=True)
class WorkloadShape:
    """One serving tier: the pods of `clique` (matched by clique TEMPLATE
    name, so every PCS replica / PCSG replica of that template counts as
    deployed capacity) absorb `demand_fraction` of the trace, and one
    ready pod serves `rps_per_replica` at utilization 1.0."""

    clique: str
    shape: str = "decode"
    rps_per_replica: float = 0.0   # 0 = take the shape default
    demand_fraction: float = 0.0   # 0 = take the shape default

    def __post_init__(self) -> None:
        defaults = DEFAULT_SHAPES.get(self.shape, DEFAULT_SHAPES["decode"])
        if self.rps_per_replica <= 0:
            self.rps_per_replica = defaults["rps_per_replica"]
        if self.demand_fraction <= 0:
            self.demand_fraction = defaults["demand_fraction"]

    def tier_demand(self, demand: float) -> float:
        return demand * self.demand_fraction

    def utilization(self, demand: float, ready_pods: int) -> float:
        """Per-pod utilization fraction of request — the metrics-server
        signal. Zero deployed capacity reports saturation (1.0 per
        nothing is meaningless; the HPA's min_replicas floor guarantees
        the denominator in steady state)."""
        if ready_pods <= 0:
            return 1.0
        return self.tier_demand(demand) / (ready_pods * self.rps_per_replica)

    def required_pods(self, demand: float, target_utilization: float) -> int:
        """Pods needed to serve `demand` at the HPA's target utilization
        — the bench's starvation/latency oracle, the same arithmetic the
        HPA converges to (epsilon-guarded against float dust on the ceil
        cliff, like the controller's own math)."""
        cap = self.rps_per_replica * max(target_utilization, 1e-9)
        return max(1, math.ceil(self.tier_demand(demand) / cap - 1e-9))
