"""Simulated kubelet + in-pod startup barrier.

Drives bound pods through Pending -> Running -> Ready, honoring the
startup-order barrier that the reference implements as the grove-initc init
container (operator/initc/): a dependent pod's main containers only start
once every parent clique has >= minAvailable ready pods
(initc/internal/wait.go:111-275). Here the barrier is an annotation on the
pod (constants.ANNOTATION_WAIT_FOR, written by the pod component exactly
where the reference injects the init container) that the kubelet checks on
every tick — same observable semantics, no container runtime.

Fault injection for the E2E suites (the reference E2E uses node cordons +
pod kills as its fault model):
  crash_pod  — container crash: pod stays bound and Running but NotReady
               with restart_count++ (CrashLoopBackOff shape). This is what
               the reference's "started but never crashed" healthiness test
               (podclique/reconcilestatus.go:176-225) keys on, and what
               drives MinAvailableBreached -> gang termination.
  evict_pod  — pod-level failure (node eviction/OOM): phase Failed, capacity
               released; the pod component replaces the pod.
  recover_pod— crashed containers come back; pod turns Ready again.
  fail_heartbeat / restore_heartbeat — node-level failure: the node's
               heartbeat lease stops renewing (partition / kubelet death);
               the NodeMonitor marks it NotReady once the lease lags and
               sweeps its pods after the eviction grace. Pods on the node
               keep their last reported state, like a real partition.

Beyond pod lifecycle, every tick renews one heartbeat Lease per live node
(cluster/nodehealth.py) — the node-lease controller the k8s node
lifecycle machinery keys on.
"""

from __future__ import annotations

from ..api import constants
from ..api.types import Node, Pod, PodPhase
from ..observability.tracing import NOOP_TRACER
from .nodehealth import renew_node_lease
from .store import ObjectStore, StoreError


def parse_wait_for(value: str) -> list[tuple[str, int]]:
    """'pclq-a:2,pclq-b:1' -> [(pclq-a, 2), (pclq-b, 1)] — the same
    dependency grammar the reference passes to grove-initc as
    --podcliques=<fqn>:<minAvailable> (pod/initcontainer.go:155).
    Raises ValueError on a malformed entry (non-integer minAvailable,
    or no ':' separator at all); SimKubelet treats that barrier as
    unsatisfiable rather than letting the tick die (see _barrier_open)."""
    out = []
    for part in value.split(","):
        if not part:
            continue
        fqn, sep, min_s = part.rpartition(":")
        if not sep or not fqn:
            raise ValueError(
                f"malformed wait-for entry {part!r}: want <fqn>:<minAvailable>"
            )
        out.append((fqn, int(min_s)))
    return out


class SimKubelet:
    """Event-driven like a real kubelet: instead of scanning every pod per
    tick (O(pods x ticks) dominated settle at 10^4-pod scale), it keeps an
    informer-style watch cursor on the store's event log and maintains the
    candidate set (bound pods that still need a lifecycle step), the ready
    set, and the live-node set incrementally. A cursor that falls behind
    the compaction horizon relists, exactly like the controller manager."""

    def __init__(self, store: ObjectStore):
        self.store = store
        #: span tracer (observability/tracing.py); Cluster.enable_tracing
        #: swaps in the recording one. Per-pod lifecycle points are gated
        #: on tracer.enabled so the disabled path allocates nothing.
        self.tracer = NOOP_TRACER
        # keyed by pod UID: a replacement pod reusing a hole-filled NAME
        # must start clean, exactly like a fresh pod in a real cluster
        self._crashed: set[str] = set()
        #: pod UIDs whose malformed wait-for annotation was already
        #: surfaced as a Warning event (once per pod, not per tick)
        self._warned_barriers: set[str] = set()
        #: namespace -> {sa: granted rules}, rebuilt lazily per tick
        self._authz_cache: dict[str, dict[str, set[str]]] = {}
        self._cursor = 0
        #: bound pods whose phase can still advance this side of ready
        self._candidates: set[tuple[str, str]] = set()
        #: pods currently reporting ready
        self._ready: set[tuple[str, str]] = set()
        self._nodes: set[str] = set()
        #: nodes deleted since the last tick (node-loss sweep targets);
        #: a node that comes back before the tick is spared, preserving
        #: the scan-at-tick-start semantics
        self._nodes_lost: set[str] = set()
        #: nodes whose heartbeat lease renewal is suppressed (injected
        #: node failure — partition, kubelet death, domain outage)
        self._hb_failed: set[str] = set()
        #: serving metrics reporter (serving/ TrafficEngine),
        #: wired by Cluster when config.serving.enabled: every tick ends
        #: with one utilization sample per READY pod — the kubelet end of
        #: the metrics pipeline (kubelet -> aggregation -> HPA sync)
        self.reporter = None

    @property
    def event_cursor(self) -> int:
        """Last store event seq this kubelet has drained (public: feeds
        the harness's safe compaction horizon)."""
        return self._cursor

    def _relist(self) -> None:
        self._candidates.clear()
        self._ready.clear()
        self._nodes = {
            n.metadata.name for n in self.store.scan(Node.KIND)
        }
        for pod in self.store.scan(Pod.KIND):
            self._observe_pod(pod)
            # the Node Deleted events may be behind the compaction
            # horizon: pods bound to a now-absent node must still be
            # swept to Failed, so their nodes re-enter the lost set
            if (
                pod.node_name
                and pod.node_name not in self._nodes
                and pod.metadata.deletion_timestamp is None
                and pod.status.phase not in (PodPhase.FAILED,
                                             PodPhase.SUCCEEDED)
            ):
                self._nodes_lost.add(pod.node_name)

    def _observe_pod(self, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        if pod.status.ready:
            self._ready.add(key)
        else:
            self._ready.discard(key)
        if (
            pod.node_name
            and pod.metadata.deletion_timestamp is None
            and (
                pod.status.phase == PodPhase.PENDING
                or (pod.status.phase == PodPhase.RUNNING
                    and not pod.status.ready)
            )
        ):
            self._candidates.add(key)
        else:
            self._candidates.discard(key)

    def _drain(self) -> None:
        try:
            events = self.store.events_since(self._cursor)
        except StoreError:
            # fell behind the compaction horizon: relist like an informer
            self._cursor = self.store.last_seq
            self._relist()
            return
        if events:
            self._cursor = events[-1].seq
        for ev in events:
            if ev.kind == Pod.KIND:
                key = (ev.namespace, ev.name)
                if ev.type == "Deleted":
                    self._candidates.discard(key)
                    self._ready.discard(key)
                else:
                    self._observe_pod(ev.obj)
            elif ev.kind == Node.KIND:
                if ev.type == "Deleted":
                    self._nodes.discard(ev.name)
                    self._nodes_lost.add(ev.name)
                else:
                    self._nodes.add(ev.name)
                    self._nodes_lost.discard(ev.name)

    def reset_for_recovery(self) -> None:
        """Re-sync against a store whose state was REPLACED under us (a
        control-plane cold restart recovered it from disk): the event
        cursor may point past the recovered head, and the incremental
        candidate/ready/node sets may reflect writes the recovery rolled
        back — relist everything from live state, like an informer after
        its watch connection died. Kubelet-side infrastructure truth
        (crashed containers, suppressed heartbeats) survives: the node
        agents did not restart, the control plane did."""
        self._cursor = self.store.last_seq
        self._authz_cache.clear()
        self._nodes_lost.clear()
        self._relist()

    def crash_pod(self, namespace: str, name: str) -> None:
        """Container crash: pod stays bound/Running but NotReady until
        recover_pod(); restart_count marks it unhealthy for MinAvailable."""
        pod = self.store.get(Pod.KIND, namespace, name)
        if pod is None:
            return
        self._crashed.add(pod.metadata.uid)
        pod.status.ready = False
        pod.status.restart_count += 1
        self.store.update_status(pod)

    def recover_pod(self, namespace: str, name: str) -> None:
        pod = self.store.get(Pod.KIND, namespace, name)
        if pod is not None:
            self._crashed.discard(pod.metadata.uid)

    def fail_heartbeat(self, node_name: str) -> None:
        """Node-level failure: stop renewing this node's heartbeat lease.
        The NodeMonitor marks it NotReady once the lease lags the freshest
        cluster heartbeat by the configured lease duration."""
        self._hb_failed.add(node_name)

    def restore_heartbeat(self, node_name: str) -> None:
        """Heartbeats resume next tick; the NodeMonitor readmits the node
        only after its stable-ready window (flap damping)."""
        self._hb_failed.discard(node_name)

    @property
    def heartbeat_failed(self) -> frozenset[str]:
        """Nodes with suppressed heartbeats (introspection/chaos driver)."""
        return frozenset(self._hb_failed)

    def evict_pod(self, namespace: str, name: str) -> None:
        """Pod-level failure: Failed phase, capacity released; the pod
        component replaces it."""
        pod = self.store.get(Pod.KIND, namespace, name)
        if pod is None:
            return
        pod.status.phase = PodPhase.FAILED
        pod.status.ready = False
        self.store.update_status(pod)

    def tick(self) -> int:
        """Advance every bound pod one lifecycle step; returns number of
        status changes (0 = kubelet quiescent).

        Barrier checks read the readiness snapshot taken at tick start, so
        readiness propagates one dependency hop per tick — without this, a
        whole startsAfter chain would cascade to ready within one tick,
        which no real cluster does (informer propagation delay)."""
        with self.tracer.span("kubelet.tick") as sp:
            return self._tick(sp)

    def _tick(self, sp) -> int:
        """tick's body; `sp` (the kubelet.tick span) gets the pods started,
        readied and lost."""
        changes = 0
        self._authz_cache.clear()
        self._drain()
        # heartbeats first: one Lease renewal per live node per clock
        # instant (renew_node_lease skips nodes already renewed at this
        # instant, so the many settle rounds per instant write once).
        # Renewals are deliberately NOT counted in `changes` — a tick that
        # only heartbeats is quiescent for the settle loop; the manager's
        # follow-up settle drains the Lease events into the NodeMonitor.
        now_hb = self.store.clock.now()
        trace = self.tracer.enabled
        with self.tracer.span("kubelet.heartbeat") as hb:
            store, failed = self.store, self._hb_failed
            done = [renew_node_lease(store, node_name, now_hb)
                    for node_name in sorted(self._nodes)  # deterministic
                    if node_name not in failed]
            if trace:
                hb.set(renewed=done.count("renewed"),
                       created=done.count("created"))
        # the readiness snapshot is the drained state: writes made DURING
        # this tick emit events that only land at the next drain, so
        # membership is exactly "ready as of tick start"
        ready_at_tick_start = self._ready
        live_nodes = self._nodes
        to_run: list[tuple[str, str]] = []
        to_start_ready: list[tuple[str, str]] = []
        to_ready: list[tuple[str, str]] = []
        to_lose: list[tuple[str, str]] = []
        if self._nodes_lost:
            # node-loss failure model (the node-lifecycle controller + pod
            # GC analog): pods bound to a DELETED node are gone — mark them
            # Failed so the clique replaces them and the scheduler rebinds
            # elsewhere (terminal pods stay as they ended — a SUCCEEDED pod
            # did not fail). Rare event: one full sweep, not per-tick cost.
            lost = self._nodes_lost
            self._nodes_lost = set()
            for pod in self.store.scan(Pod.KIND):
                if (
                    pod.node_name in lost
                    and pod.metadata.deletion_timestamp is None
                    and pod.status.phase not in (PodPhase.FAILED,
                                                 PodPhase.SUCCEEDED)
                ):
                    to_lose.append(
                        (pod.metadata.namespace, pod.metadata.name)
                    )
        pod_bucket = self.store.kind_bucket(Pod.KIND)  # read-only
        #: key -> (gang label, node, has startup barrier) for the pod
        #: lifecycle trace points; only populated when tracing is on
        pod_meta: dict[tuple[str, str], tuple[str, str, bool]] = {}
        for key in sorted(self._candidates):
            pod = pod_bucket.get(key)
            if (
                pod is None
                or not pod.node_name
                or pod.metadata.deletion_timestamp is not None
            ):
                continue
            if pod.node_name not in live_nodes:
                continue  # swept via _nodes_lost above
            if pod.metadata.uid in self._crashed:
                continue  # stays NotReady until recover_pod
            if pod.spec.scheduling_gates:
                continue
            if trace:
                pod_meta[key] = (
                    pod.metadata.labels.get(constants.LABEL_PODGANG, ""),
                    pod.node_name,
                    bool(pod.metadata.annotations.get(
                        constants.ANNOTATION_WAIT_FOR
                    )),
                )
            if pod.status.phase == PodPhase.PENDING:
                # container start and readiness land in ONE tick when the
                # startup barrier is already open as of tick start (the
                # common, dependency-free case) — readiness still
                # propagates at most one dependency hop per tick, which is
                # the invariant the startup-order suites pin down
                if self._barrier_open(pod, ready_at_tick_start):
                    to_start_ready.append(key)
                else:
                    to_run.append(key)
            elif pod.status.phase == PodPhase.RUNNING and not pod.status.ready:
                if self._barrier_open(pod, ready_at_tick_start):
                    to_ready.append(key)
        now = self.store.clock.now()

        def lost(status):
            status.phase = PodPhase.FAILED
            status.ready = False

        for ns, name in to_lose:
            changes += self.store.patch_status(Pod.KIND, ns, name, lost)
        n_lost = changes
        started = readied = 0

        def start(status):
            status.phase = PodPhase.RUNNING
            status.started_at = now

        def ready(status):
            status.ready = True
            status.ever_started = True

        def start_ready(status):
            status.phase = PodPhase.RUNNING
            status.started_at = now
            status.ready = True
            status.ever_started = True

        for ns, name in to_run:
            if self.store.patch_status(Pod.KIND, ns, name, start):
                changes += 1
                started += 1
                if trace:
                    self._trace_pod("kubelet.pod_start", ns, name, pod_meta)
        for ns, name in to_start_ready:
            if self.store.patch_status(Pod.KIND, ns, name, start_ready):
                changes += 1
                started += 1
                readied += 1
                if trace:
                    # start + barrier release land in one tick: both
                    # lifecycle points, in order
                    self._trace_pod("kubelet.pod_start", ns, name, pod_meta)
                    self._trace_pod("kubelet.pod_ready", ns, name, pod_meta)
        for ns, name in to_ready:
            if self.store.patch_status(Pod.KIND, ns, name, ready):
                changes += 1
                readied += 1
                if trace:
                    self._trace_pod("kubelet.pod_ready", ns, name, pod_meta)
        if self.reporter is not None:
            # serving metrics reporting rides the tick like the heartbeat
            # renewals: the reported capacity is the readiness snapshot as
            # of tick start (this tick's readiness writes drain next tick
            # — the one-hop propagation delay a real metrics-server
            # pipeline has), and reporting is NOT counted in `changes` —
            # a tick that only reports metrics is quiescent for settle.
            self.reporter.report(self.store, now, self._ready)
        if trace:
            sp.set(started=started, readied=readied, lost=n_lost)
        return changes

    def _trace_pod(self, span_name: str, ns: str, pod_name: str,
                   meta: dict) -> None:
        """Pod lifecycle trace point (pod_start / pod_ready — the latter
        IS the startup-barrier release when `barrier` is set). Gang-tagged
        so GangTimeline can stitch per-gang startup phases; links the
        gang's bind-emitted causal token so the kubelet hop joins the
        gang's flow DAG (observability/causal.py)."""
        gang, node, barrier = meta.get((ns, pod_name), ("", "", False))
        causal = {}
        ledger = getattr(self.store, "causal", None)
        if ledger is not None and gang:
            tok = ledger.follow(("gang", ns, gang))
            if tok is not None:
                causal["causal_link"] = tok
        self.tracer.point(
            span_name, pod=f"{ns}/{pod_name}", namespace=ns, gang=gang,
            node=node, barrier=barrier, **causal,
        )

    def run_to_quiesce(self, max_ticks: int = 64) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0:
                return

    def _barrier_open(self, pod, ready_set: set[tuple[str, str]]) -> bool:
        """initc equivalent: all parent cliques have >= min ready pods (as
        of tick start). The watch runs AS the pod's ServiceAccount
        identity (the token secret the reference mounts for grove-initc,
        initc/internal/wait.go:76-90): without a RoleBinding granting
        pods watch, the barrier cannot observe its parents and stays
        closed — RBAC is enforced, not decorative."""
        spec = pod.metadata.annotations.get(constants.ANNOTATION_WAIT_FOR, "")
        if not spec:
            return True
        try:
            deps = parse_wait_for(spec)
        except ValueError as exc:
            # A malformed annotation (hand-edited pod, or a buggy writer)
            # must not kill the kubelet tick for every OTHER pod on the
            # node: the barrier is simply unsatisfiable — the pod stays
            # Pending/NotReady, a Warning event says why (once), and a
            # corrected annotation self-heals on a later tick.
            if pod.metadata.uid not in self._warned_barriers:
                self._warned_barriers.add(pod.metadata.uid)
                from ..observability.events import (
                    EventRecorder,
                    REASON_INVALID_STARTUP_BARRIER,
                )

                EventRecorder(self.store, controller="kubelet").warning(
                    pod,
                    REASON_INVALID_STARTUP_BARRIER,
                    f"unsatisfiable startup barrier {spec!r}: {exc}",
                )
            return False
        ns = pod.metadata.namespace
        sa = pod.spec.service_account_name
        if sa:
            grants = self._authz_cache.get(ns)
            if grants is None:
                grants = self._authz_cache[ns] = self.store.read_grants(ns)
            if "pods:watch" not in grants.get(sa, ()):
                return False  # Forbidden: cannot observe parents
        for pclq_fqn, min_available in deps:
            ready = sum(
                1
                for p in self.store.scan(
                    Pod.KIND,
                    namespace=pod.metadata.namespace,
                    labels={constants.LABEL_PODCLIQUE: pclq_fqn},
                )
                if (p.metadata.namespace, p.metadata.name) in ready_set
            )
            if ready < min_available:
                return False
        return True
