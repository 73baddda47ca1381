"""In-process HPA controller.

The reference creates autoscaling/v2 HPAs and lets kube's HPA controller
PATCH the scale subresource of PodClique/PodCliqueScalingGroup
(components/hpa/hpa.go; scale markers on all 3 CRDs). Here the control
loop itself runs in-process against the HorizontalPodAutoscaler objects:
desired = ceil(current * observed_utilization / target), clamped to
[min, max], written to the target's spec.replicas — the same math as the
k8s HPA algorithm, including:

  - the tolerance band (no scale while |ratio - 1| <= tolerance);
  - missing/stale metrics NEVER drive scale-down (a partitioned tier
    holds instead of collapsing to min);
  - the scale-down stabilization window (k8s
    stabilizationWindowSeconds): desired-on-scale-down is the MAX
    recommendation over the trailing window, so one noisy trough in the
    signal cannot flap the replica count — the diurnal traffic trace
    exercises this immediately.

Utilization comes from the cluster-owned PodMetrics aggregator
(serving/pipeline.py — the metrics-server stand-in that
SimKubelet's per-tick reporting feeds when serving is enabled). Tests
and callers may still hand-feed samples via `observe()`; both paths land
in the same aggregator, which survives manager crash-restarts. The
stabilization history is controller-local and rebuilds empty on a
crash-restart, exactly like the kube HPA controller's (a post-crash
scale-down may fire one window early — conservative in capacity terms).

The periodic sweep (`run_all`, driven by Harness.autoscale /
maybe_autoscale on the `autoscaler.sync_interval_seconds` cadence)
tolerates per-HPA store faults: a transient write failure skips that HPA
until the next sync instead of aborting the sweep.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

from ..api import constants
from ..api.auxiliary import HorizontalPodAutoscaler
from ..api.types import Pod, PodCliqueScalingGroup
from ..cluster.cluster import Cluster
from ..cluster.store import Event
from .runtime import Request, Result

KIND = HorizontalPodAutoscaler.KIND


class Autoscaler:
    name = "autoscaler"
    watch_kinds = frozenset((KIND,))

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.store = cluster.store
        cfg = cluster.config.autoscaler
        # k8s HPA tolerance: no scale while |ratio - 1| <= tolerance
        self.tolerance = cfg.tolerance
        self.sync_interval = cfg.sync_interval_seconds
        self.stabilization = cfg.scale_down_stabilization_seconds
        self.metrics = cluster.metrics
        #: the cluster-owned sample aggregator (metrics-server stand-in);
        #: a pre-serving custom Cluster fixture gets a private one
        self.pipeline = getattr(cluster, "pod_metrics", None)
        if self.pipeline is None:  # pragma: no cover - legacy fixtures
            from ..serving import PodMetrics

            self.pipeline = PodMetrics(cfg.metrics_max_age_seconds)
        #: per-HPA recommendation history for the scale-down
        #: stabilization window: (namespace, name) -> deque of
        #: (virtual timestamp, clamped recommendation). Only REAL
        #: signals are recorded (utilization None records nothing), so a
        #: metrics-less HPA never pins its own current count into the
        #: window.
        self._recommendations: dict[
            tuple[str, str], collections.deque
        ] = {}
        #: virtual time of the last periodic sweep (Harness.maybe_autoscale
        #: cadence); -inf so the first opportunity always sweeps
        self.last_sync = float("-inf")

    def map_event(self, event: Event) -> list[Request]:
        # Only spec changes (new HPA / retargeted bounds) trigger an
        # immediate evaluation. Status writes must NOT — reacting to our own
        # status update would re-evaluate stale metrics against the
        # already-scaled replica count and double-scale. Periodic evaluation
        # happens via run_all() (the HPA sync interval).
        if event.kind == KIND and (
            event.type == "Added"
            or (
                event.old is not None
                and event.obj.metadata.generation != event.old.metadata.generation
            )
        ):
            return [Request(event.namespace, event.name)]
        return []

    def observe(self, pod_name: str, utilization: float,
                namespace: str | None = None) -> None:
        """Feed a metric sample by hand (tests and callers — the serving
        pipeline reports through the same aggregator); call
        harness.autoscale() to run the loop. Without a namespace the
        sample matches the pod name in ANY namespace (the legacy
        bare-name convention; pipeline.ANY_NAMESPACE fallback)."""
        self.pipeline.report(
            pod_name, utilization, self.store.clock.now(),
            namespace=(
                namespace if namespace is not None
                else self.pipeline.ANY_NAMESPACE
            ),
        )

    def reconcile(self, request: Request) -> Result:
        hpa = self.store.get(KIND, request.namespace, request.name)
        if hpa is None or hpa.metadata.deletion_timestamp is not None:
            self._recommendations.pop((request.namespace, request.name), None)
            return Result()
        self._scale(hpa)
        return Result()

    def run_all(self) -> None:
        """One sweep over every HPA (the periodic HPA sync). Also the
        aggregator's GC point: samples for pods that no longer exist are
        pruned (the dict would otherwise grow unbounded across pod churn
        and stale samples of a deleted pod would survive forever)."""
        self.last_sync = self.store.clock.now()
        self.metrics.counter(
            "grove_autoscaler_syncs_total", "periodic HPA sync sweeps"
        ).inc()
        live = {
            (p.metadata.namespace, p.metadata.name)
            for p in self.store.scan(Pod.KIND)
        }
        dropped = self.pipeline.gc(live)
        if dropped:
            self.metrics.counter(
                "grove_autoscaler_samples_gced_total",
                "utilization samples pruned for deleted pods",
            ).inc(dropped)
        hpas = self.store.list(KIND)
        keys = {(h.metadata.namespace, h.metadata.name) for h in hpas}
        for k in [k for k in self._recommendations if k not in keys]:
            del self._recommendations[k]
        for hpa in hpas:
            try:
                self._scale(hpa)
            except Exception:
                # a transient store fault (chaos write failure, conflict)
                # must not abort the whole sweep: this HPA retries on the
                # next sync, the rest scale now. ManagerCrash is a
                # BaseException and still propagates. The counter is the
                # visibility: a persistently failing HPA shows up as a
                # per-sync error stream, not a silent hold.
                self.metrics.counter(
                    "grove_autoscaler_sync_errors_total",
                    "per-HPA sweep failures skipped until the next sync",
                ).inc(hpa=f"{hpa.metadata.namespace}/{hpa.metadata.name}")
                continue

    def _scale(self, hpa: HorizontalPodAutoscaler) -> None:
        ns = hpa.metadata.namespace
        target = self.store.get(hpa.spec.target_kind, ns, hpa.spec.target_name)
        if target is None:
            return
        now = self.store.clock.now()
        current = target.spec.replicas
        lo, hi = hpa.spec.min_replicas, hpa.spec.max_replicas
        utilization = self._observed_utilization(hpa, target, now)
        if utilization is None:
            desired = current
        else:
            ratio = utilization / max(hpa.spec.target_utilization, 1e-9)
            # the epsilon keeps float dust off the ceil cliff (k8s does
            # this math in integer milli-units; here 126/120/0.7 is
            # 1.5000000000000002 and a bare ceil would scale 2 -> 4)
            raw = (
                current
                if abs(ratio - 1.0) <= self.tolerance
                else max(1, math.ceil(current * ratio - 1e-9))
            )
            raw = min(max(raw, lo), hi)
            desired = raw
            recs = self._recommendations.setdefault(
                (ns, hpa.metadata.name), collections.deque()
            )
            recs.append((now, raw))
            while recs and now - recs[0][0] > self.stabilization:
                recs.popleft()
            if raw < current and self.stabilization > 0:
                # k8s scale-down stabilization: act on the MAX
                # recommendation over the window, never above current (a
                # down decision must not become an up one)
                stabilized = min(current, max(r for _, r in recs))
                if stabilized > raw:
                    self.metrics.counter(
                        "grove_autoscaler_stabilized_holds_total",
                        "scale-downs raised/held by the stabilization "
                        "window",
                    ).inc()
                desired = stabilized
        desired = min(max(desired, lo), hi)
        if desired != current:
            target.spec.replicas = desired
            self.store.update(target)
            hpa.status.last_scale_time = now
            self.metrics.counter(
                "grove_autoscaler_scale_events_total",
                "applied HPA scale events by direction",
            ).inc(direction="up" if desired > current else "down")
        if (
            hpa.status.current_replicas != current
            or hpa.status.desired_replicas != desired
        ):
            hpa.status.current_replicas = current
            hpa.status.desired_replicas = desired
            self.store.update_status(hpa)

    def _observed_utilization(self, hpa, target, now) -> Optional[float]:
        """Average utilization over the target's pods (k8s HPA averages
        over READY pods of the scale target). Samples come from the
        aggregator with its staleness horizon: a pod whose metrics
        stopped flowing (metrics_dropout, partition) reads as missing,
        and with NO fresh samples at all there is no basis to scale
        (k8s HPA: missing metrics never drive scale-down)."""
        ns = hpa.metadata.namespace
        if hpa.spec.target_kind == PodCliqueScalingGroup.KIND:
            label = {constants.LABEL_PCSG: hpa.spec.target_name}
        else:
            label = {constants.LABEL_PODCLIQUE: hpa.spec.target_name}
        pods = [
            p
            for p in self.store.list(Pod.KIND, namespace=ns, labels=label)
            if p.status.ready
        ]
        samples = []
        for p in pods:
            util = self.pipeline.get(
                p.metadata.name, now, namespace=p.metadata.namespace
            )
            if util is not None:
                samples.append(util)
        if not samples:
            return None
        return sum(samples) / len(samples)
