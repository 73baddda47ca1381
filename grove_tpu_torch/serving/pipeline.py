"""The serving metrics pipeline: kubelet -> aggregation -> HPA sync.

Replaces the hand-fed `Autoscaler.observe()` path with the real loop a
production fleet runs: every SimKubelet tick reports one utilization
sample per READY pod (computed by the TrafficEngine from the traffic
trace and the pod's workload shape), samples land in the cluster-owned
PodMetrics aggregator (the metrics-server stand-in — timestamped, with a
staleness horizon, GC'd for deleted pods), and the Autoscaler's periodic
sync reads aggregated per-target utilization from it.

PodMetrics is CLUSTER-owned (like the DecisionLog and TenancyManager):
samples are infrastructure truth reported by the node agents, so they
survive manager crash-restarts — a rebuilt autoscaler resumes from the
same aggregator instead of a blank dict.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..api import constants
from ..api.types import PodClique
from .traffic import SpikeEvent, TrafficTrace, WorkloadShape

if TYPE_CHECKING:  # pragma: no cover
    from ..api.config import ServingConfig


class PodMetrics:
    """Metrics-server stand-in: (namespace, pod name) ->
    (utilization, timestamp). Keyed by the FULL pod identity — two
    same-named PodCliqueSets in different namespaces produce pods with
    identical bare names, and a name-keyed map would let one tier's
    samples overwrite the other's.

    Samples older than `max_age_seconds` are STALE and read as missing —
    the k8s contract that missing metrics never drive scale-down rides on
    this horizon (a partitioned tier stops reporting; its HPA must hold,
    not collapse to min). `dropout_steps` is the chaos hook: while > 0,
    report() drops everything on the floor (metrics-pipeline outage); the
    chaos driver decrements it per step and zeroes it at disarm."""

    #: namespace sentinel for hand-fed samples whose caller did not say
    #: (Autoscaler.observe's legacy bare-name convention): get() falls
    #: back to it, so a hand-fed sample matches the pod regardless of
    #: namespace — exactly what the pre-pipeline name-keyed dict did.
    #: Kubelet-reported samples are always properly namespaced.
    ANY_NAMESPACE = "*"

    def __init__(self, max_age_seconds: float = 120.0):
        self.max_age_seconds = max_age_seconds
        #: (namespace, pod name) -> (utilization fraction, virtual ts)
        self._samples: dict[tuple[str, str], tuple[float, float]] = {}
        #: chaos metrics_dropout: steps of suppressed reporting remaining
        self.dropout_steps = 0
        self.reports_total = 0
        self.dropped_total = 0

    def report(self, pod_name: str, utilization: float, now: float,
               namespace: str = ANY_NAMESPACE) -> None:
        if self.dropout_steps > 0:
            self.dropped_total += 1
            return
        self._samples[(namespace, pod_name)] = (float(utilization), now)
        self.reports_total += 1

    def get(self, pod_name: str, now: float,
            namespace: str = ANY_NAMESPACE) -> Optional[float]:
        """The FRESH sample, or None. A namespaced read falls back to
        the ANY_NAMESPACE series (hand-fed samples) when the namespaced
        entry is absent OR stale — a stale kubelet sample must not
        shadow a fresh hand-fed one."""
        candidates = [(namespace, pod_name)]
        if namespace != self.ANY_NAMESPACE:
            candidates.append((self.ANY_NAMESPACE, pod_name))
        for key in candidates:
            entry = self._samples.get(key)
            if entry is not None and now - entry[1] <= self.max_age_seconds:
                return entry[0]
        return None

    def gc(self, live_pod_keys: set[tuple[str, str]]) -> int:
        """Drop samples for pods that no longer exist (the autoscaler
        sweep calls this with the live (namespace, name) set; without it
        the dict grows unbounded across pod churn and stale samples
        survive forever). ANY_NAMESPACE samples live while any pod bears
        the name. Returns entries dropped."""
        live_names = {name for _, name in live_pod_keys}
        dead = [
            k for k in self._samples
            if k not in live_pod_keys
            and not (k[0] == self.ANY_NAMESPACE and k[1] in live_names)
        ]
        for k in dead:
            del self._samples[k]
        return len(dead)

    def tick_dropout(self) -> None:
        if self.dropout_steps > 0:
            self.dropout_steps -= 1

    def __len__(self) -> int:
        return len(self._samples)

    def debug_state(self) -> dict:
        return {
            "samples": len(self._samples),
            "max_age_seconds": self.max_age_seconds,
            "dropout_steps": self.dropout_steps,
            "reports_total": self.reports_total,
            "dropped_total": self.dropped_total,
        }


class TrafficEngine:
    """Maps the TrafficTrace through per-clique WorkloadShapes onto the
    per-pod utilization samples the kubelet reports each tick.

    Wired by Cluster when config.serving.enabled: SimKubelet calls
    `report(store, now, ready_keys)` at the end of every tick. Chaos
    injects transient spikes via `inject_spike` (kept apart from the
    trace's own scheduled spikes so disarm can remove exactly the
    injected ones and the post-chaos fixpoint matches fault-free)."""

    def __init__(self, config: "ServingConfig", pod_metrics: PodMetrics,
                 metrics=None):
        self.trace = TrafficTrace.from_config(config.trace)
        self.workloads = [WorkloadShape(**w) for w in config.workloads]
        self.pod_metrics = pod_metrics
        self.metrics = metrics
        #: chaos-injected spikes (cleared at disarm)
        self._injected: list[SpikeEvent] = []
        #: (namespace, clique name) -> clique template name memo; the
        #: template label of a given clique name never changes, so the
        #: memo only ever grows — bounded by the safety clear
        self._template_memo: dict[tuple[str, str], str] = {}

    # -- demand ------------------------------------------------------------
    def demand(self, now: float) -> float:
        return self.trace.demand(now, extra_spikes=tuple(self._injected))

    def inject_spike(self, at: float, duration: float,
                     multiplier: float) -> SpikeEvent:
        spike = SpikeEvent(
            at_seconds=at, duration_seconds=duration, multiplier=multiplier
        )
        self._injected.append(spike)
        return spike

    def clear_injected(self) -> int:
        n = len(self._injected)
        self._injected = []
        return n

    @property
    def injected_spikes(self) -> tuple[SpikeEvent, ...]:
        return tuple(self._injected)

    def shape_for(self, clique_template: str) -> Optional[WorkloadShape]:
        for w in self.workloads:
            if w.clique == clique_template:
                return w
        return None

    # -- the kubelet-side reporting hook -----------------------------------
    def template_of(self, store, ns: str, clique_name: str) -> str:
        """Clique FQN -> clique template name, resolved through the
        PodClique's LABEL_CLIQUE_TEMPLATE label (memoized — the label of
        a given clique name never changes). Public: the diurnal bench
        groups ready pods per tier through the same resolution instead
        of baking in naming conventions."""
        return self._template_of(store, ns, clique_name)

    def _template_of(self, store, ns: str, clique_name: str) -> str:
        key = (ns, clique_name)
        tmpl = self._template_memo.get(key)
        if tmpl is None:
            pclq = store.peek(PodClique.KIND, ns, clique_name)
            if pclq is None:
                return ""
            tmpl = pclq.metadata.labels.get(
                constants.LABEL_CLIQUE_TEMPLATE, ""
            )
            if len(self._template_memo) > 100_000:  # safety: churn leak
                self._template_memo.clear()
            self._template_memo[key] = tmpl
        return tmpl

    def report(self, store, now: float,
               ready_keys: set[tuple[str, str]]) -> None:
        """One metrics-reporting pass: compute each serving tier's
        utilization from current demand and DEPLOYED ready capacity,
        stamp it on every ready pod of the tier. Pods of cliques outside
        the configured workloads report nothing (no signal — their HPAs,
        if any, hold per the missing-metrics rule)."""
        if not self.workloads:
            return
        from ..api.types import Pod

        demand = self.demand(now)
        #: clique template -> [(namespace, pod name)]
        tier_pods: dict[str, list[tuple[str, str]]] = {
            w.clique: [] for w in self.workloads
        }
        pod_bucket = store.kind_bucket(Pod.KIND)  # read-only
        for key in ready_keys:
            pod = pod_bucket.get(key)
            if pod is None or pod.metadata.deletion_timestamp is not None:
                continue
            clique = pod.metadata.labels.get(constants.LABEL_PODCLIQUE)
            if not clique:
                continue
            tmpl = self._template_of(store, key[0], clique)
            if tmpl in tier_pods:
                tier_pods[tmpl].append(key)
        for shape in self.workloads:
            pods = tier_pods[shape.clique]
            util = shape.utilization(demand, len(pods))
            for ns, name in pods:
                self.pod_metrics.report(name, util, now, namespace=ns)
            if self.metrics is not None:
                self.metrics.gauge(
                    "grove_serving_tier_utilization",
                    "per-pod utilization fraction by serving tier",
                ).set(util, clique=shape.clique)
                self.metrics.gauge(
                    "grove_serving_tier_ready_pods",
                    "ready pods counted as deployed capacity per tier",
                ).set(float(len(pods)), clique=shape.clique)
        if self.metrics is not None:
            self.metrics.gauge(
                "grove_serving_demand_rps",
                "offered load of the traffic trace (requests/sec)",
            ).set(demand)

    def debug_state(self) -> dict:
        return {
            "trace": {
                "base_rps": self.trace.base_rps,
                "peak_rps": self.trace.peak_rps,
                "period_seconds": self.trace.period_seconds,
                "noise": self.trace.noise,
                "scheduled_spikes": len(self.trace.spikes),
            },
            "workloads": [
                {
                    "clique": w.clique,
                    "shape": w.shape,
                    "rps_per_replica": w.rps_per_replica,
                    "demand_fraction": w.demand_fraction,
                }
                for w in self.workloads
            ],
            "injected_spikes": len(self._injected),
            "pipeline": self.pod_metrics.debug_state(),
        }
