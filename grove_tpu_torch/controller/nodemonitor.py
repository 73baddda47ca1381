"""NodeMonitor: the node-lifecycle controller.

The k8s node-lifecycle controller re-homed onto the deterministic runtime:

  detect   — a node whose heartbeat lease lags the freshest cluster
             heartbeat by more than `cluster.node_lease_duration_seconds`
             goes NotReady (Ready condition on the Node). Lag is measured
             against the NEWEST lease, not wall-now, so virtual clock
             jumps (test advance(), chaos) can never NotReady a healthy
             fleet — only a node whose peers kept heartbeating while it
             did not.
  grace    — pods on a NotReady node are swept to Failed (capacity
             released, cliques replace them, the scheduler re-places onto
             healthy domains) only after `pod_eviction_grace_seconds`; a
             node that recovers inside the grace causes zero evictions.
  damp     — a recovered node re-enters the candidate set only after
             `node_stable_ready_seconds` of continuous renewal, and the
             Ready flip additionally requires a lease renewed within the
             lease duration of *now* — so a flapping node cannot thrash
             the placement engine, and a dead node cannot ride one stale
             renewal back to Ready.
  drain    — a node stamped with the drain annotation (Cluster.drain) is
             evicted gang-aware: per clique, the PDB-shaped budget
             `healthy - minAvailable` evicts freely; at zero budget a
             fully-healthy clique gives up one pod at a time, each
             eviction licensed by a capacity check that its replacement
             can actually be placed elsewhere; when it cannot, the WHOLE
             gang is terminated (DisruptionTarget + pods deleted) so it
             re-queues atomically instead of wedging half-broken.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..api import constants
from ..api.meta import get_condition, set_condition
from ..api.podgang import PodGang, PodGangConditionType, PodGangPhase
from ..api.types import NODE_CONDITION_READY, Node, Pod, PodPhase, node_ready
from ..cluster.cluster import Cluster
from ..cluster.nodehealth import (
    NODE_LEASE_NAMESPACE,
    NodeLease,
    node_lease_renew_times,
    set_node_ready,
)
from ..cluster.store import Event
from ..observability.events import (
    EventRecorder,
    REASON_DRAIN_GANG_TERMINATED,
    REASON_NODE_DRAINED,
    REASON_NODE_NOT_READY,
    REASON_NODE_READY,
    REASON_NODE_PODS_EVICTED,
)
from ..solver.problem import pod_eligibility_mask
from .common import is_pod_healthy
from .runtime import Request, Result

_SINGLETON_REQ = Request("", "nodes")
_EPS = 1e-9

#: terminal pod phases (a Succeeded pod on a lost node did not fail)
_TERMINAL = (PodPhase.SUCCEEDED, PodPhase.FAILED)


def _active_bound(pod: Pod) -> bool:
    return bool(
        pod.node_name
        and pod.metadata.deletion_timestamp is None
        and pod.status.phase not in _TERMINAL
    )


class NodeMonitor:
    name = "nodemonitor"
    watch_kinds = frozenset((Node.KIND, NodeLease.KIND, Pod.KIND))

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.store = cluster.store
        cfg = cluster.config.cluster
        self.lease_duration = cfg.node_lease_duration_seconds
        self.eviction_grace = cfg.pod_eviction_grace_seconds
        self.stable_ready = cfg.node_stable_ready_seconds
        self.retry_seconds = (
            cluster.config.controllers.sync_retry_interval_seconds
        )
        self.metrics = cluster.metrics
        self.recorder = EventRecorder(cluster.store, controller=self.name)
        self.log = cluster.logger.with_name(self.name)
        #: span tracer (observability/tracing.py): eviction sweeps and
        #: drain passes are traced — they are the node-lifecycle events a
        #: chaos postmortem needs causality for. No-op unless cluster
        #: tracing is enabled.
        self.tracer = cluster.tracer
        #: node -> virtual time its post-recovery stabilization began.
        #: In-memory on purpose: a restarted manager conservatively
        #: restarts the window (same shape as the reference's expectation
        #: stores — rebuilt from observation, never from the object).
        self._stable_since: dict[str, float] = {}
        #: nodes whose NodeDrained event was already emitted (drop when
        #: the drain mark clears, so a re-drain re-announces)
        self._drained_announced: set[str] = set()
        #: True while any draining node still holds active pods — gates
        #: the Pod-event wakeups (drains are rare; pod churn is not)
        self._drain_in_flight = False
        #: node -> last exported lifecycle state: the change tracker
        #: behind the per-node grove_node_lifecycle_states series, so a
        #: reconcile writes O(changed) gauge series, and a DELETED node's
        #: series is removed instead of lingering in /metrics forever
        self._node_states: dict[str, str] = {}

    # -- watch plumbing ------------------------------------------------------
    def map_event(self, event: Event) -> list[Request]:
        out: list[Request] = []
        self.map_events((event,), lambda _name, req: out.append(req))
        return out

    def map_events(self, events, enqueue) -> None:
        """Node and node-Lease events always wake the monitor; Pod events
        only while a drain is in flight (eviction pacing keys on
        replacement readiness). Leader-election leases live outside
        NODE_LEASE_NAMESPACE and are ignored."""
        queued = False
        for event in events:
            kind = event.kind
            if kind == Node.KIND:
                queued = True
            elif kind == NodeLease.KIND:
                if event.namespace == NODE_LEASE_NAMESPACE:
                    queued = True
            elif kind == Pod.KIND and self._drain_in_flight:
                queued = True
        if queued:
            enqueue(self.name, _SINGLETON_REQ)

    def debug_state(self) -> dict:
        """Read-only introspection for observability.debug."""
        return {
            "stabilizing_nodes": len(self._stable_since),
            "drain_in_flight": self._drain_in_flight,
            "drained_announced": len(self._drained_announced),
        }

    # -- the sweep -----------------------------------------------------------
    def reconcile(self, request: Request) -> Result:
        now = self.store.clock.now()
        renews = node_lease_renew_times(self.store)
        newest = max(renews.values(), default=0.0)
        nodes = self.store.scan(Node.KIND)
        live_names = set()
        next_deadline: Optional[float] = None

        def arm(at: float) -> None:
            nonlocal next_deadline
            if next_deadline is None or at < next_deadline:
                next_deadline = at

        draining: list[Node] = []
        sweep_targets: list[str] = []
        for node in nodes:
            name = node.metadata.name
            live_names.add(name)
            if node.metadata.deletion_timestamp is not None:
                continue
            if node.metadata.annotations.get(constants.ANNOTATION_DRAIN):
                draining.append(node)
            is_ready = node_ready(node)
            renew = renews.get(name, node.metadata.creation_timestamp)
            expired = newest - renew > self.lease_duration
            if expired:
                self._stable_since.pop(name, None)
                if is_ready:
                    if set_node_ready(
                        self.store, name, False, reason="HeartbeatLost",
                        message=(
                            f"lease lags freshest heartbeat by "
                            f"{newest - renew:.0f}s"
                        ),
                        now=now,
                    ):
                        self._note_not_ready(node)
                # grace runs from the NotReady transition (re-read: the
                # flip above may have just stamped it)
                live = self.store.peek(Node.KIND, "default", name)
                cond = (
                    get_condition(
                        live.status.conditions, NODE_CONDITION_READY
                    )
                    if live is not None
                    else None
                )
                not_ready_at = (
                    cond.last_transition_time if cond is not None else now
                )
                deadline = not_ready_at + self.eviction_grace
                if now + _EPS >= deadline:
                    sweep_targets.append(name)
                else:
                    arm(deadline)
            elif is_ready:
                self._stable_since.pop(name, None)
            else:
                # NotReady but the lease is not lagging its peers: either
                # a direct failure stamp whose heartbeat died at the same
                # instant (expiry shows once peers renew), or a recovered
                # node stabilizing. Only a lease renewed within the lease
                # duration of NOW counts toward stabilization — a stale
                # snapshot of a dead node must not ride back to Ready.
                if now - renew > self.lease_duration:
                    continue  # wait for a renewal event
                since = self._stable_since.setdefault(name, now)
                if now + _EPS - since >= self.stable_ready:
                    if set_node_ready(
                        self.store, name, True, reason="NodeStableReady",
                        message=(
                            f"heartbeats stable for {now - since:.0f}s"
                        ),
                        now=now,
                    ):
                        self.recorder.normal(
                            node, REASON_NODE_READY,
                            "node readmitted to the candidate set",
                        )
                        self.log.info("node ready", node=name)
                    del self._stable_since[name]
                else:
                    arm(since + self.stable_ready)

        if sweep_targets:
            self._sweep_pods(sweep_targets)

        # drop stabilization state for vanished nodes + GC orphan leases
        for gone in set(self._stable_since) - live_names:
            del self._stable_since[gone]
        for lease_name in sorted(set(renews) - live_names):
            self.store.delete(
                NodeLease.KIND, NODE_LEASE_NAMESPACE, lease_name
            )

        drain_pending = self._reconcile_drains(draining, live_names)
        # per-node one-hot state series from POST-write state (the
        # kube-state-metrics shape: sum by (state) recovers the old
        # aggregate counts, and each node carries exactly one series).
        # Change-tracked: a reconcile writes O(changed states) series,
        # and a deleted node's series is REMOVED — /metrics must never
        # carry ghosts of departed inventory.
        states: dict[str, str] = {}
        for node in self.store.scan(Node.KIND):
            if node.metadata.deletion_timestamp is not None:
                continue
            name = node.metadata.name
            if not node_ready(node):
                states[name] = "not_ready"
            elif node.metadata.annotations.get(constants.ANNOTATION_DRAIN):
                states[name] = "draining"
            elif node.unschedulable:
                states[name] = "unschedulable"
            else:
                states[name] = "ready"
        gauge = self.metrics.gauge(
            "grove_node_lifecycle_states",
            "one series per live node, value 1 at its current lifecycle "
            "state (not_ready > draining > unschedulable > ready); "
            "sum by (state) for fleet counts",
        )
        prev = self._node_states
        if not prev:
            # fresh monitor over a long-lived registry (manager
            # crash-restart): adopt the gauge's existing series as the
            # baseline so nodes deleted while the manager was down get
            # their series removed too
            for labels in gauge.label_sets():
                if "node" in labels:
                    prev.setdefault(labels["node"], labels.get("state", ""))
        for name, state in states.items():
            was = prev.get(name)
            if was == state:
                continue
            if was is not None:
                gauge.remove(node=name, state=was)
            gauge.set(1.0, node=name, state=state)
        for gone in set(prev) - set(states):
            gauge.remove(node=gone, state=prev[gone])
        self._node_states = states
        requeue = None
        if next_deadline is not None:
            requeue = max(next_deadline - now, _EPS)
        if drain_pending:
            # waiting on replacement readiness: pod events drive the next
            # eviction; the timer is the liveness net
            requeue = min(requeue or self.retry_seconds, self.retry_seconds)
        return Result(requeue_after=requeue)

    def _note_not_ready(self, node: Node) -> None:
        self.recorder.warning(
            node, REASON_NODE_NOT_READY,
            "heartbeat lease expired; node left the candidate set",
        )
        self.log.info("node not ready", node=node.metadata.name)
        self.metrics.counter(
            "grove_node_not_ready_total",
            "Ready=False transitions marked by the node monitor",
        ).inc()

    # -- NotReady pod sweep --------------------------------------------------
    def _sweep_pods(self, node_names: list[str]) -> None:
        """The pod-eviction-timeout sweep: every active pod bound to an
        expired node goes Failed (capacity released; the owning clique
        replaces it and the scheduler re-places onto healthy domains).
        Idempotent — patch_status writes only on change, and no new pod
        can bind to a NotReady node. One pod scan for the whole batch: a
        domain outage expires a rack at once, and the monitor wakes on
        every heartbeat, so per-node scans were O(nodes x pods) for the
        outage's whole duration."""
        targets = set(node_names)
        victims: dict[str, list[tuple[str, str]]] = {}
        for p in self.store.scan(Pod.KIND):
            if p.node_name in targets and _active_bound(p):
                victims.setdefault(p.node_name, []).append(
                    (p.metadata.namespace, p.metadata.name)
                )

        def fail(status):
            status.phase = PodPhase.FAILED
            status.ready = False

        sweep_sp = self.tracer.span(
            "nodemonitor.evict_sweep", nodes=len(node_names)
        )
        total_swept = 0
        with sweep_sp:
            for node_name in node_names:
                total_swept += self._sweep_node(
                    node_name, victims.get(node_name, ()), fail
                )
        sweep_sp.set(swept=total_swept)

    def _sweep_node(self, node_name: str, node_victims, fail) -> int:
        """Fail every active pod of one expired node; returns the count."""
        swept = 0
        for ns, name in node_victims:
            swept += self.store.patch_status(Pod.KIND, ns, name, fail)
        if swept:
            self.metrics.counter(
                "grove_node_pod_evictions_total",
                "pods swept to Failed off NotReady nodes after the "
                "eviction grace",
            ).inc(swept)
            node = self.store.peek(Node.KIND, "default", node_name)
            if node is not None:
                self.recorder.warning(
                    node, REASON_NODE_PODS_EVICTED,
                    f"evicted {swept} pod(s) after "
                    f"{self.eviction_grace:.0f}s NotReady",
                )
            self.log.info(
                "swept NotReady node", node=node_name, pods=swept,
            )
        return swept

    # -- gang-aware drain ----------------------------------------------------
    def _reconcile_drains(
        self, draining: list[Node], live_names: set[str]
    ) -> bool:
        """Returns True while any draining node still holds active pods."""
        self._drained_announced &= live_names
        drain_names = {n.metadata.name for n in draining}
        # a node whose drain mark cleared (uncordon) may be re-drained
        # later: forget the announcement
        self._drained_announced &= drain_names
        pending = False
        if draining:
            pods = self.store.scan(Pod.KIND)
            # pods evicted earlier in THIS pass: the scan list is a
            # snapshot, so without this a clique spanning two draining
            # nodes would spend its PDB budget once per node and dip
            # below MinAvailable
            evicted: set[tuple[str, str]] = set()
            with self.tracer.span(
                "nodemonitor.drain_pass", nodes=len(draining)
            ) as dsp:
                for node in draining:
                    if self._drain_one(node, pods, evicted):
                        pending = True
                dsp.set(evicted=len(evicted), pending=pending)
        self._drain_in_flight = pending
        return pending

    def _drain_one(
        self,
        node: Node,
        all_pods: list[Pod],
        evicted: set[tuple[str, str]],
    ) -> bool:
        """One pacing step for one draining node; returns True while
        active pods remain."""
        name = node.metadata.name
        on_node = [
            p for p in all_pods
            if p.node_name == name
            and _active_bound(p)
            and (p.metadata.namespace, p.metadata.name) not in evicted
        ]
        if not on_node:
            if name not in self._drained_announced:
                self._drained_announced.add(name)
                self.recorder.normal(
                    node, REASON_NODE_DRAINED,
                    "drain complete: no active pods remain",
                )
                self.log.info("node drained", node=name)
            return False
        # budgets are per (namespace, clique): a multi-tenant node hosts
        # cliques from several namespaces, and same-named cliques in
        # different namespaces are distinct PDBs
        by_clique: dict[tuple[str, str], list[Pod]] = {}
        unowned: list[Pod] = []
        for p in on_node:
            clique = p.metadata.labels.get(constants.LABEL_PODCLIQUE)
            if clique:
                key = (p.metadata.namespace, clique)
                by_clique.setdefault(key, []).append(p)
            else:
                unowned.append(p)
        # pods outside any clique have no gang budget to honor
        for p in unowned:
            self._evict(p, name, evicted)
        for ns, clique_name in sorted(by_clique):
            self._drain_clique(
                name, ns, clique_name, by_clique[(ns, clique_name)],
                all_pods, evicted,
            )
        return True

    def _drain_clique(
        self,
        node_name: str,
        ns: str,
        clique_name: str,
        on_node: list[Pod],
        all_pods: list[Pod],
        evicted: set[tuple[str, str]],
    ) -> None:
        from ..api.types import PodClique

        pclq = self.store.peek(PodClique.KIND, ns, clique_name)
        if pclq is None:
            for p in on_node:
                self._evict(p, node_name, evicted)  # orphans: no budget
            return
        min_avail = pclq.spec.min_available or pclq.spec.replicas
        members = [
            p
            for p in all_pods
            if p.metadata.namespace == ns
            and p.metadata.labels.get(constants.LABEL_PODCLIQUE)
            == clique_name
            and p.metadata.deletion_timestamp is None
            and p.status.phase not in _TERMINAL
            and (p.metadata.namespace, p.metadata.name) not in evicted
        ]
        healthy = sum(1 for p in members if is_pod_healthy(p))
        budget = healthy - min_avail  # the PDB disruption allowance
        on_node_sorted = sorted(on_node, key=lambda p: p.metadata.name)
        if budget > 0:
            for p in on_node_sorted[:budget]:
                self._evict(p, node_name, evicted)
            return
        if healthy == len(members) and len(members) >= pclq.spec.replicas:
            # zero budget but the clique is whole: give up one pod at a
            # time, and only when its replacement can actually land
            # somewhere — "no faster than replacements become Ready".
            victim = on_node_sorted[0]
            if self._placeable_elsewhere(victim):
                self._evict(victim, node_name, evicted)
            else:
                self._terminate_gang_of(victim, node_name, evicted)
            return
        # below complement / replacements not Ready yet: if an unbound
        # replacement provably cannot be placed, the gang cannot be
        # rebuilt incrementally — terminate it so it re-queues atomically.
        stuck = next(
            (
                p
                for p in members
                if not p.node_name
                and not p.spec.scheduling_gates
                and not self._placeable_elsewhere(p)
            ),
            None,
        )
        if stuck is not None:
            self._terminate_gang_of(stuck, node_name, evicted)
        # else: replacements in flight — pod events pace the next step

    def _placeable_elsewhere(self, pod: Pod) -> bool:
        """Capacity check licensing an eviction: some schedulable node
        (the draining node is cordoned, NotReady nodes are excluded) fits
        the pod's demand and its node filters. Conservative about pack
        constraints — a gang-level violation surfaces later as the gang's
        own repair problem, but a pod with literally nowhere to go must
        not be evicted piecemeal."""
        snap = self.cluster.topology_snapshot()
        req = pod.spec.total_requests()
        demand = np.asarray(
            [req.get(r, 0.0) for r in snap.resource_names],
            dtype=np.float32,
        )
        ok = snap.schedulable & np.all(
            snap.free + _EPS >= demand, axis=1
        )
        mask = pod_eligibility_mask(
            snap,
            (pod.spec.node_selector, pod.spec.tolerations),
            snap.has_taints,
        )
        if mask is not None:
            ok = ok & mask
        return bool(ok.any())

    def _evict(
        self,
        pod: Pod,
        node_name: str,
        evicted: set[tuple[str, str]] | None = None,
    ) -> None:
        """Graceful drain eviction: delete the pod; the owning clique
        recreates it (hole-filled name) and the scheduler binds it off
        the cordoned node."""
        self.store.delete(
            Pod.KIND, pod.metadata.namespace, pod.metadata.name
        )
        if evicted is not None:
            evicted.add((pod.metadata.namespace, pod.metadata.name))
        self.metrics.counter(
            "grove_node_drain_evictions_total",
            "pods evicted by gang-aware node drains",
        ).inc()
        self.log.info(
            "drain evicted pod", node=node_name, pod=pod.metadata.name,
        )

    def _terminate_gang_of(
        self,
        pod: Pod,
        node_name: str,
        evicted: set[tuple[str, str]] | None = None,
    ) -> None:
        """Drain fallback: the gang cannot be rebuilt around this pod —
        mark it DisruptionTarget, drop Scheduled and delete every
        referenced pod, so the gang re-queues as a whole at its own
        priority (same disruption shape as scheduler preemption)."""
        ns = pod.metadata.namespace
        gang_name = pod.metadata.labels.get(constants.LABEL_PODGANG)
        if not gang_name:
            self._evict(pod, node_name, evicted)  # no gang: plain evict
            return
        gang = self.store.peek(PodGang.KIND, ns, gang_name)
        if gang is None or gang.metadata.deletion_timestamp is not None:
            return
        now = self.store.clock.now()
        msg = f"gang cannot be rebuilt around draining node {node_name}"

        def mutate(status):
            status.phase = PodGangPhase.PENDING
            status.placement_score = None
            set_condition(
                status.conditions,
                PodGangConditionType.DISRUPTION_TARGET.value,
                "True", reason="DrainCannotRebuild", message=msg, now=now,
            )
            set_condition(
                status.conditions,
                PodGangConditionType.SCHEDULED.value,
                "False", reason="Drained", message=msg, now=now,
            )

        # change-detected: False means the conditions were already stamped
        # by an earlier attempt. The member deletes still run — a crash or
        # write fault between the patch and the deletes would otherwise
        # leave the termination half-done FOREVER (every retry would see
        # the no-op patch and return before deleting the survivors). The
        # deletes are idempotent; only the announcement is once-only.
        first = self.store.patch_status(PodGang.KIND, ns, gang_name, mutate)
        for group in gang.spec.pod_groups:
            for ref in group.pod_references:
                member = self.store.peek(Pod.KIND, ref.namespace, ref.name)
                if (
                    member is not None
                    and member.metadata.deletion_timestamp is None
                ):
                    self.store.delete(Pod.KIND, ref.namespace, ref.name)
                    if evicted is not None:
                        evicted.add((ref.namespace, ref.name))
        if not first:
            return
        self.metrics.counter(
            "grove_node_drain_gang_terminations_total",
            "gangs terminated whole because a drain could not rebuild "
            "them incrementally",
        ).inc()
        self.recorder.warning(gang, REASON_DRAIN_GANG_TERMINATED, msg)
        self.log.info(
            "drain terminated gang", node=node_name, gang=gang_name,
        )
