"""PodCliqueSet reconciler: the root controller.

Mirrors the reference's PCS reconciler structure
(operator/internal/controller/podcliqueset/): spec flow = finalizer ->
generation-hash bookkeeping -> ordered component sync (rbac -> headless
services -> HPAs -> replica gang-termination -> standalone PodCliques ->
PodCliqueScalingGroups -> PodGangs), then the status flow computing
available/updated replicas and the TopologyLevelsUnavailable condition.

The podgang component is the heart of gang semantics
(components/podgang/syncflow.go): one BASE PodGang per PCS replica holding
the standalone cliques plus PCSG replicas [0, minAvailable), one SCALED
PodGang per PCSG replica beyond minAvailable, 3-level topology constraints
(PCS->gang, PCSG->constraint group, PCLQ->pod group), and creation DEFERRED
until every expected pod exists and carries the gang label
(syncflow.go:435-502).
"""

from __future__ import annotations

from typing import Optional

from ..api import constants, naming
from ..api.config import OperatorConfig
from ..api.auxiliary import (
    HorizontalPodAutoscaler,
    HPASpec,
    Role,
    RoleBinding,
    Secret,
    Service,
    ServiceAccount,
)
from ..api.meta import NamespacedName, get_condition, set_condition
from ..api.podgang import (
    PodGang,
    PodGangConditionType,
    PodGangSpec,
    PodGroup,
    TopologyConstraint,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from ..api.types import (
    ClusterTopology,
    Pod,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueScalingGroupSpec,
    PodCliqueSet,
    PodCliqueSpec,
    TopologyConstraintSpec,
)
from ..cluster.store import Event, ObjectStore, _shallow, clone
from ..observability.events import (
    EventRecorder,
    REASON_GANG_TERMINATED,
)
from .common import base_labels, is_pod_active, new_meta, pcs_generation_hash
from .errors import GroveError, clear_status_errors, record_pcs_error
from .runtime import Request, Result

KIND = PodCliqueSet.KIND


def _min_requeue(a: Optional[float], b: Optional[float]) -> Optional[float]:
    """Earliest of two optional requeue delays."""
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)

#: child kinds whose events map to the owning PCS via the part-of label
#: (built from the classes' KIND attributes so a kind-string change can
#: never desync this from watch_kinds)
_CHILD_KINDS = frozenset(
    (PodClique.KIND, PodCliqueScalingGroup.KIND, Pod.KIND, PodGang.KIND)
)


class PodCliqueSetReconciler:
    name = "podcliqueset"
    #: auxiliary managed kinds: a deletion out from under the operator is
    #: healed by the component syncs (create-if-missing), so it must mark
    #: the spec flow dirty
    AUX_KINDS = frozenset(
        (
            Service.KIND,
            HorizontalPodAutoscaler.KIND,
            Secret.KIND,
            Role.KIND,
            RoleBinding.KIND,
            ServiceAccount.KIND,
        )
    )
    watch_kinds = frozenset(
        (
            KIND,
            PodClique.KIND,
            PodCliqueScalingGroup.KIND,
            Pod.KIND,
            PodGang.KIND,
            ClusterTopology.KIND,
        )
    ) | AUX_KINDS

    def __init__(self, store: ObjectStore, config: OperatorConfig | None = None):
        self.store = store
        self.config = config or OperatorConfig()
        self.recorder = EventRecorder(store, controller=self.name)
        #: event seqs of this reconciler's own child CREATES/spec
        #: updates (cliques, PCSGs, gangs). Expectations analog, same
        #: rationale as PodCliqueReconciler._own_events: the spec flow
        #: that made the write is already consistent with it, so the echo
        #: must not re-dirty the spec flow. Deletes stay live (the
        #: delete->recreate chain of gang termination rides them).
        self._own_events: set[int] = set()
        #: PCS keys whose next reconcile must run the FULL spec flow
        #: (component syncs). The generation-change predicate analog
        #: (register.go predicates): pure status writes on owned objects
        #: only need the status/termination/rollout flows, and at
        #: 1000-replica scale the component syncs re-running per pod
        #: status event dominated settle wall-clock.
        self._spec_dirty: set[tuple[str, str]] = set()

    def record_error(self, request: Request, err: GroveError) -> None:
        """Manager error hook: surface to status.last_errors/last_operation
        (reconcile_error_recorder.go analog)."""
        record_pcs_error(self.store, request.namespace, request.name, err)

    def _mark_own(self) -> None:
        """Record the event seq of a child write this reconciler just
        made (see _own_events). Single-threaded store: store.last_seq
        right after a write IS that write's event."""
        self._own_events.add(self.store.last_seq)
        if len(self._own_events) > 100_000:  # safety: undrained leak
            self._own_events.clear()

    # -- watches (register.go:53-121; the generation-change predicates the
    # reference attaches to its watches are what keeps pod status churn
    # from re-running component syncs) -------------------------------------
    def map_event(self, event: Event) -> list[Request]:
        """Single-event watch predicate, expressed via the batched path
        (the runtime drains through map_events; this remains for direct
        callers/tests)."""
        out: list[Request] = []
        self.map_events((event,), lambda _name, req: out.append(req))
        return out

    def map_events(self, events, enqueue) -> None:
        """Batched watch predicate (one call per runtime drain round —
        per-event call + return-list overhead was measurable at
        10^4-event settle scale). Semantics are those the per-event
        comments below describe; map_event is the 1-tuple view."""
        name_ = self.name
        spec_dirty = self._spec_dirty
        own = self._own_events
        aux = self.AUX_KINDS
        for event in events:
            kind = event.kind
            if kind == KIND:
                if event.type != "Modified" or event.old is None or (
                    event.obj.metadata.generation
                    != event.old.metadata.generation
                ):
                    spec_dirty.add((event.namespace, event.name))
                enqueue(name_, Request(event.namespace, event.name))
            elif kind in _CHILD_KINDS:
                if event.seq in own:
                    own.discard(event.seq)
                    continue
                owner = event.obj.metadata.labels.get(constants.LABEL_PART_OF)
                if not owner:
                    continue
                spec_relevant = (
                    event.type != "Modified" or event.old is None or (
                        event.obj.metadata.generation
                        != event.old.metadata.generation
                    )
                )
                if kind == Pod.KIND:
                    # the podgang component consumes the pod INVENTORY:
                    # pods appearing/leaving or flipping active-ness
                    # (Failed / Succeeded / marked deleting). Phase/
                    # readiness churn rolls up through the owning
                    # PodClique's status, and pod SPEC changes (= gate
                    # removal, the only pod generation bump) feed nothing
                    # at the PCS level either — no reconcile.
                    if event.type == "Modified" and event.old is not None \
                            and (
                                is_pod_active(event.obj)
                                == is_pod_active(event.old)
                            ):
                        continue
                    spec_dirty.add((event.namespace, owner))
                elif kind == PodGang.KIND:
                    # gang status (Scheduled/phase) never feeds the PCS
                    # flows; inventory/spec changes re-run the podgang
                    # component
                    if not spec_relevant:
                        continue
                    spec_dirty.add((event.namespace, owner))
                elif spec_relevant:
                    spec_dirty.add((event.namespace, owner))
                # clique/PCSG status Modifieds still enqueue:
                # availability, breach clocks and rollout progress read
                # their status
                enqueue(name_, Request(event.namespace, owner))
            elif kind in aux:
                # self-heal: a managed Service/HPA/RBAC object deleted
                # out from under the operator is recreated by the
                # component syncs
                owner = event.obj.metadata.labels.get(constants.LABEL_PART_OF)
                if owner and event.type == "Deleted":
                    spec_dirty.add((event.namespace, owner))
                    enqueue(name_, Request(event.namespace, owner))
            elif kind == ClusterTopology.KIND:
                # Level set changed: every PCS must re-translate its
                # PodGang constraints and refresh
                # TopologyLevelsUnavailable.
                for p in self.store.scan(KIND):
                    key = (p.metadata.namespace, p.metadata.name)
                    spec_dirty.add(key)
                    enqueue(name_, Request(*key))

    # -- reconcile ---------------------------------------------------------
    def reconcile(self, request: Request) -> Result:
        key = (request.namespace, request.name)
        spec_dirty = key in self._spec_dirty
        self._spec_dirty.discard(key)
        try:
            pcs = self.store.get(KIND, request.namespace, request.name)
            if pcs is None:
                return Result()
            if pcs.metadata.deletion_timestamp is not None:
                return self._reconcile_delete(pcs)
            self.store.add_finalizer(
                KIND, request.namespace, request.name, constants.FINALIZER_PCS
            )
            if spec_dirty:
                requeue = self._reconcile_spec(pcs)
            else:
                # status-only trigger: availability/breach/rollout flows.
                # Rollout progression targets a NEW replica (template
                # propagation is a component-sync job), so advancing falls
                # back to the full spec flow.
                requeue = self._sync_replicas(pcs)
                if self._sync_rolling_update(pcs):
                    self._sync_podcliques(pcs)
                    self._sync_pcsgs(pcs)
                    requeue = _min_requeue(
                        requeue, self._sync_podgangs(pcs)
                    )
            self._reconcile_status(pcs)
        except BaseException:
            # the retry (backoff requeue, or relist after a manager
            # crash) must re-run the spec flow, not silently degrade to
            # the status flow — and the bit must survive failures OUTSIDE
            # the spec flow too (add_finalizer, the status write), or one
            # transient store fault swallows the pending spec work
            if spec_dirty:
                self._spec_dirty.add(key)
            raise
        return Result(requeue_after=requeue)

    # -- delete flow (reconciledelete.go) ----------------------------------
    def _reconcile_delete(self, pcs: PodCliqueSet) -> Result:
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        labels = {constants.LABEL_PART_OF: name}
        for kind in (
            PodGang.KIND,
            PodClique.KIND,
            PodCliqueScalingGroup.KIND,
            Pod.KIND,
            Service.KIND,
            HorizontalPodAutoscaler.KIND,
            Secret.KIND,
            RoleBinding.KIND,
            Role.KIND,
            ServiceAccount.KIND,
        ):
            for child in self.store.scan(kind, namespace=ns, labels=labels):
                if child.metadata.deletion_timestamp is None:
                    self.store.delete(kind, ns, child.metadata.name)
                for fin in list(child.metadata.finalizers):
                    self.store.remove_finalizer(kind, ns, child.metadata.name, fin)
        self.store.remove_finalizer(KIND, ns, name, constants.FINALIZER_PCS)
        return Result()

    # -- spec flow (reconcilespec.go:41-57) --------------------------------
    def _reconcile_spec(self, pcs: PodCliqueSet) -> Optional[float]:
        self._process_generation_hash(pcs)
        self._sync_rbac(pcs)
        self._sync_services(pcs)
        self._sync_hpas(pcs)
        requeue = self._sync_replicas(pcs)
        self._sync_rolling_update(pcs)
        self._sync_podcliques(pcs)
        self._sync_pcsgs(pcs)
        requeue = _min_requeue(requeue, self._sync_podgangs(pcs))
        return requeue

    def _process_generation_hash(self, pcs: PodCliqueSet) -> None:
        """Template-hash change detection: a change initiates the rolling
        update (reconcilespec.go:72-122); a further change mid-update
        restarts it toward the new target."""
        from ..api.types import PCSRollingUpdateProgress

        new_hash = pcs_generation_hash(pcs)
        status = pcs.status
        before = clone(status)
        if status.current_generation_hash == "":
            status.current_generation_hash = new_hash
        elif status.current_generation_hash != new_hash:
            prog = status.rolling_update_progress
            if prog is None or prog.target_generation_hash != new_hash:
                status.rolling_update_progress = PCSRollingUpdateProgress(
                    update_started_at=self.store.clock.now(),
                    target_generation_hash=new_hash,
                )
        status.observed_generation = pcs.metadata.generation
        if status != before:
            self.store.update_status(pcs)

    def _sync_rolling_update(self, pcs: PodCliqueSet) -> bool:
        """One-replica-at-a-time orchestration (rollingupdate.go:40-73).
        Advances current_replica_index as replicas finish (detected by hash
        propagation, updates.clique_updated); on completion stamps the new
        generation hash. Returns True when progress was written (the
        status-only reconcile path then re-runs the component syncs to
        propagate the template to the newly-targeted replica)."""
        from . import updates

        status = pcs.status
        prog = status.rolling_update_progress
        if prog is None or prog.completed:
            return False
        before = clone(status)
        updates.prune_vanished_replicas(prog, pcs.spec.replicas)
        if prog.current_replica_index is not None and self._replica_updated(
            pcs, prog.current_replica_index
        ):
            prog.updated_replica_indices.append(prog.current_replica_index)
            prog.current_replica_index = None
        if prog.current_replica_index is None:
            remaining = [
                i
                for i in range(pcs.spec.replicas)
                if i not in prog.updated_replica_indices
            ]
            if not remaining:
                prog.completed = True
                status.current_generation_hash = prog.target_generation_hash
            else:
                prog.current_replica_index = updates.pick_next_replica(
                    self.store, pcs, remaining
                )
        status.updated_replicas = (
            pcs.spec.replicas if prog.completed
            else len(prog.updated_replica_indices)
        )
        if status != before:
            self.store.update_status(pcs)
            return True
        return False

    def _replica_updated(self, pcs: PodCliqueSet, replica: int) -> bool:
        """All standalone + PCSG-owned cliques of the replica carry the
        target template and have re-readied (hash-propagation completion)."""
        from .updates import clique_template_hashes, clique_updated

        ns, name = pcs.metadata.namespace, pcs.metadata.name
        hashes = clique_template_hashes(pcs)
        sel = {
            constants.LABEL_PART_OF: name,
            constants.LABEL_PCS_REPLICA_INDEX: str(replica),
        }
        pclqs = self.store.scan(PodClique.KIND, namespace=ns, labels=sel)
        if not pclqs:
            return False
        for pclq in pclqs:
            template = pclq.metadata.labels.get(constants.LABEL_CLIQUE_TEMPLATE, "")
            target = hashes.get(template)
            if target is None or not clique_updated(self.store, pclq, target):
                return False
        return True

    # -- components --------------------------------------------------------
    def _sync_rbac(self, pcs: PodCliqueSet) -> None:
        """SA + Role + RoleBinding + token Secret per PCS (the identity the
        startup-barrier watcher uses; components/{serviceaccount,role,
        rolebinding,satokensecret}/)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        labels = base_labels(name)
        sa_name = f"{name}-sa"
        if self.store.peek(ServiceAccount.KIND, ns, sa_name) is None:
            self.store.create(
                ServiceAccount(metadata=new_meta(sa_name, ns, pcs, labels)),
                owned=True,
            )
        role_name = f"{name}-pod-reader"
        if self.store.peek(Role.KIND, ns, role_name) is None:
            self.store.create(
                Role(metadata=new_meta(role_name, ns, pcs, labels)), owned=True
            )
        rb_name = f"{name}-pod-reader"
        if self.store.peek(RoleBinding.KIND, ns, rb_name) is None:
            self.store.create(
                RoleBinding(
                    metadata=new_meta(rb_name, ns, pcs, labels),
                    role_name=role_name,
                    service_account_name=sa_name,
                ),
                owned=True,
            )
        secret_name = f"{name}-sa-token"
        if self.store.peek(Secret.KIND, ns, secret_name) is None:
            self.store.create(
                Secret(
                    metadata=new_meta(secret_name, ns, pcs, labels),
                    service_account_name=sa_name,
                ),
                owned=True,
            )

    def _sync_services(self, pcs: PodCliqueSet) -> None:
        """Headless Service per PCS replica (service.go:119-204)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        cfg = pcs.spec.template.head_less_service_config
        expected = {
            naming.headless_service_name(name, i): i
            for i in range(pcs.spec.replicas)
        }
        labels = dict(
            base_labels(name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_HEADLESS_SERVICE},
        )
        for svc_name, i in expected.items():
            if self.store.peek(Service.KIND, ns, svc_name) is None:
                self.store.create(
                    Service(
                        metadata=new_meta(svc_name, ns, pcs, labels),
                        selector={
                            constants.LABEL_PART_OF: name,
                            constants.LABEL_PCS_REPLICA_INDEX: str(i),
                        },
                        publish_not_ready_addresses=(
                            cfg.publish_not_ready_addresses if cfg else True
                        ),
                    ),
                    owned=True,
                )
        for svc in self.store.scan(Service.KIND, namespace=ns, labels=labels):
            if svc.metadata.name not in expected:
                self.store.delete(Service.KIND, ns, svc.metadata.name)

    def _sync_hpas(self, pcs: PodCliqueSet) -> None:
        """HPA per scaled PCLQ and per scaled PCSG (hpa.go)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        labels = dict(
            base_labels(name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_HPA},
        )
        expected: dict[str, HPASpec] = {}
        for i in range(pcs.spec.replicas):
            for clique in pcs.spec.template.cliques:
                sc = clique.spec.scale_config
                if sc is None:
                    continue
                target = naming.podclique_name(name, i, clique.name)
                expected[naming.hpa_name(target)] = HPASpec(
                    target_kind=PodClique.KIND,
                    target_name=target,
                    min_replicas=sc.min_replicas,
                    max_replicas=sc.max_replicas,
                    target_resource=sc.target_resource,
                    target_utilization=sc.target_utilization,
                )
            for sg in pcs.spec.template.pod_clique_scaling_group_configs:
                if sg.scale_config is None:
                    continue
                target = naming.pcsg_name(name, i, sg.name)
                expected[naming.hpa_name(target)] = HPASpec(
                    target_kind=PodCliqueScalingGroup.KIND,
                    target_name=target,
                    min_replicas=sg.scale_config.min_replicas,
                    max_replicas=sg.scale_config.max_replicas,
                    target_resource=sg.scale_config.target_resource,
                    target_utilization=sg.scale_config.target_utilization,
                )
        for hpa_name, spec in expected.items():
            existing = self.store.peek(HorizontalPodAutoscaler.KIND, ns, hpa_name)
            if existing is None:
                self.store.create(
                    HorizontalPodAutoscaler(
                        metadata=new_meta(hpa_name, ns, pcs, labels), spec=spec
                    ),
                    owned=True,
                )
            elif existing.spec != spec:
                # template drift: a changed scaleConfig (new bounds /
                # target) must reach the live HPA — create-if-missing
                # alone left the old bounds pinned forever after a
                # rolling update retargeted the template
                fresh = self.store.get(HorizontalPodAutoscaler.KIND, ns, hpa_name)
                fresh.spec = spec
                self.store.update(fresh)
        for hpa in self.store.scan(
            HorizontalPodAutoscaler.KIND, namespace=ns, labels=labels
        ):
            if hpa.metadata.name not in expected:
                self.store.delete(HorizontalPodAutoscaler.KIND, ns, hpa.metadata.name)

    def _sync_replicas(self, pcs: PodCliqueSet) -> Optional[float]:
        """Gang termination (podcliquesetreplica/gangterminate.go:68-213):
        a PCS replica whose constituents breach MinAvailable for longer
        than TerminationDelay has ALL its PodCliques deleted; the spec flow
        then recreates them fresh (gang restart). Returns a requeue delay
        when a breach is ticking but not yet expired."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        delay = pcs.spec.template.termination_delay or float(
            self.config.workload_defaults.termination_delay_seconds
        )
        now = self.store.clock.now()
        min_wait: Optional[float] = None
        by_replica = self._constituents_by_replica(ns, name)
        for i in range(pcs.spec.replicas):
            breach_since: Optional[float] = None
            for obj in by_replica.get(i, ()):
                cond = get_condition(
                    obj.status.conditions, constants.CONDITION_MIN_AVAILABLE_BREACHED
                )
                if cond is not None and cond.status == "True":
                    t = cond.last_transition_time
                    breach_since = t if breach_since is None else min(breach_since, t)
            if breach_since is None:
                continue
            if now - breach_since >= delay:
                self._terminate_replica(pcs, i)
            else:
                remaining = delay - (now - breach_since)
                min_wait = remaining if min_wait is None else min(min_wait, remaining)
        return min_wait

    def _constituents_by_replica(self, ns: str, name: str):
        """PCS-replica index -> [PodClique + PCSG constituents]. ONE scan
        per kind, grouped in Python — the per-replica indexed scans this
        replaces cost O(replicas) store round-trips per reconcile, which
        dominated the PCS flows at 1000-replica scale. Read-only: callers
        only inspect conditions/availability."""
        sel = {constants.LABEL_PART_OF: name}
        out: dict[int, list] = {}
        for kind in (PodClique.KIND, PodCliqueScalingGroup.KIND):
            for obj in self.store.scan(kind, namespace=ns, labels=sel):
                idx = obj.metadata.labels.get(
                    constants.LABEL_PCS_REPLICA_INDEX
                )
                if idx is not None:
                    out.setdefault(int(idx), []).append(obj)
        return out

    def _terminate_replica(self, pcs: PodCliqueSet, replica: int) -> None:
        """Delete every PodClique of the replica (PCSG-owned included) and
        its PodGangs; reconcile recreates them (gang restart)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        self.recorder.warning(
            pcs,
            REASON_GANG_TERMINATED,
            f"replica {replica}: MinAvailable breached longer than "
            f"terminationDelay; deleting constituent PodCliques and PodGangs",
        )
        sel = {
            constants.LABEL_PART_OF: name,
            constants.LABEL_PCS_REPLICA_INDEX: str(replica),
        }
        for pclq in self.store.scan(PodClique.KIND, namespace=ns, labels=sel):
            if pclq.metadata.deletion_timestamp is None:
                self.store.delete(PodClique.KIND, ns, pclq.metadata.name)
        for gang in self.store.list(PodGang.KIND, namespace=ns, labels=sel):
            # Mark the victim BEFORE deletion (podgang.go:156-169): the
            # scheduler-side contract distinguishes deliberate disruption
            # (gang termination) from member failure, and the marking is
            # observable in the store's event log.
            set_condition(
                gang.status.conditions,
                PodGangConditionType.DISRUPTION_TARGET.value,
                "True",
                reason="GangTerminationDelayExpired",
                message="MinAvailable breached longer than terminationDelay",
                now=self.store.clock.now(),
            )
            self.store.update_status(gang)
            self.store.delete(PodGang.KIND, ns, gang.metadata.name)

    def _sync_podcliques(self, pcs: PodCliqueSet) -> None:
        """Standalone PCLQ CRs per replica (components/podclique/)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        in_pcsg = {
            cn
            for sg in pcs.spec.template.pod_clique_scaling_group_configs
            for cn in sg.clique_names
        }
        expected: dict[str, tuple[int, str, PodCliqueSpec]] = {}
        for i in range(pcs.spec.replicas):
            for clique in pcs.spec.template.cliques:
                if clique.name in in_pcsg:
                    continue
                fqn = naming.podclique_name(name, i, clique.name)
                expected[fqn] = (i, clique.name, clique.spec)
        comp_labels = dict(
            base_labels(name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_PCS_PODCLIQUE},
        )
        prog = pcs.status.rolling_update_progress
        updating_replica = (
            prog.current_replica_index
            if prog is not None and not prog.completed
            else None
        )
        for fqn, (i, clique_name, spec) in expected.items():
            existing = self.store.peek(PodClique.KIND, ns, fqn)
            if existing is not None:
                # Template propagation is gated on the rolling update: only
                # the current-update replica receives the new pod template
                # (one replica at a time; HPA-owned replica counts are
                # preserved — reference buildResource, podclique.go:308-318).
                if i == updating_replica:
                    new_spec = _copy_spec(spec)
                    new_spec.replicas = existing.spec.replicas
                    if existing.spec != new_spec:
                        fresh = self.store.get(PodClique.KIND, ns, fqn)
                        fresh.spec = new_spec
                        self.store.update(fresh)
                        self._mark_own()
                continue
            labels = dict(
                comp_labels,
                **{
                    constants.LABEL_PCS_REPLICA_INDEX: str(i),
                    constants.LABEL_PODGANG: naming.base_podgang_name(name, i),
                    constants.LABEL_CLIQUE_TEMPLATE: clique_name,
                },
            )
            self.store.create(
                PodClique(
                    metadata=new_meta(fqn, ns, pcs, labels),
                    # share the FROZEN template's substructure (pod_spec
                    # etc.) across replicas instead of a deep copy per
                    # clique: the store never mutates in place (MVCC), and
                    # one shared pod_spec object also means ONE template-
                    # hash memo entry for the whole PCS instead of one
                    # sha1 per clique
                    spec=_shallow_spec(spec),
                ),
                owned=True,
            )
            self._mark_own()
        for pclq in self.store.scan(PodClique.KIND, namespace=ns, labels=comp_labels):
            if pclq.metadata.name not in expected:
                self.store.delete(PodClique.KIND, ns, pclq.metadata.name)

    def _sync_pcsgs(self, pcs: PodCliqueSet) -> None:
        """PCSG CRs per replica; replicas are read from a live (HPA-mutated)
        PCSG when present (components/podcliquescalinggroup/)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        comp_labels = dict(
            base_labels(name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_PCSG},
        )
        expected = set()
        for i in range(pcs.spec.replicas):
            for sg in pcs.spec.template.pod_clique_scaling_group_configs:
                fqn = naming.pcsg_name(name, i, sg.name)
                expected.add(fqn)
                if self.store.peek(PodCliqueScalingGroup.KIND, ns, fqn) is not None:
                    continue
                labels = dict(
                    comp_labels,
                    **{constants.LABEL_PCS_REPLICA_INDEX: str(i)},
                )
                self.store.create(
                    PodCliqueScalingGroup(
                        metadata=new_meta(fqn, ns, pcs, labels),
                        spec=PodCliqueScalingGroupSpec(
                            replicas=sg.replicas or 1,
                            min_available=sg.min_available or 1,
                            clique_names=list(sg.clique_names),
                            topology_constraint=sg.topology_constraint,
                        ),
                    ),
                    owned=True,
                )
                self._mark_own()
        for pcsg in self.store.scan(
            PodCliqueScalingGroup.KIND, namespace=ns, labels=comp_labels
        ):
            if pcsg.metadata.name not in expected:
                self.store.delete(PodCliqueScalingGroup.KIND, ns, pcsg.metadata.name)

    # -- podgang component (components/podgang/syncflow.go) ----------------
    def _sync_podgangs(self, pcs: PodCliqueSet) -> Optional[float]:
        """Returns a requeue delay when any gang's creation was DEFERRED
        on an incomplete pod inventory. The deferral used to rely purely
        on a future pod event to re-trigger the flow — which starves
        forever when the inventory only LOOKED incomplete (a stale/lagging
        cache read: the pods exist, their events are already consumed).
        Deferring now always arms the retry timer, the same
        self-requeue-on-expectation-miss contract the reference gets from
        its expectations store + ERR_REQUEUE_AFTER."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        levels = (
            self._topology_levels()
            if self.config.topology_aware_scheduling.enabled
            else None  # disabled: constraints are ignored, not unresolved
        )
        expected = self._compute_expected_podgangs(pcs, levels)
        comp_labels = dict(
            base_labels(name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_PODGANG},
        )
        # tenant attribution rides the owning PCS's label onto every gang
        # it creates (tenancy/; namespace == tenant name is the
        # label-less fallback). NOT folded into comp_labels: the orphan-GC
        # scan below selects on comp_labels, and gangs created before a
        # PCS grew its tenant label must stay collectable.
        tenant_labels = {}
        tenant = pcs.metadata.labels.get(constants.LABEL_TENANT)
        if tenant:
            tenant_labels[constants.LABEL_TENANT] = tenant
        # causal flow (observability/causal.py): each created gang emits
        # its first token (linking the federation route's PCS token when
        # one exists) — the head of the gang's critical-path DAG
        tracer = getattr(self.store, "tracer", None)
        if tracer is not None and not tracer.enabled:
            tracer = None
        ledger = (
            getattr(self.store, "causal", None)
            if tracer is not None else None
        )
        deferred = False
        for gang_name, (replica, spec, extra_labels) in expected.items():
            pods_by_group = {}
            complete = True
            for group in spec.pod_groups:
                pods = [
                    p
                    for p in self.store.scan(
                        Pod.KIND,
                        namespace=ns,
                        labels={
                            constants.LABEL_PODCLIQUE: group.name,
                            constants.LABEL_PODGANG: gang_name,
                        },
                    )
                    if is_pod_active(p)
                ]
                pclq = self.store.peek(PodClique.KIND, ns, group.name)
                want = pclq.spec.replicas if pclq else 0
                if pclq is None or len(pods) < want:
                    complete = False  # defer until the pod inventory is full
                    break
                pods.sort(key=lambda p: p.metadata.name)
                pods_by_group[group.name] = [
                    NamespacedName(namespace=ns, name=p.metadata.name) for p in pods
                ]
            existing = self.store.peek(PodGang.KIND, ns, gang_name)
            if not complete:
                if existing is None:
                    deferred = True  # re-examine on the timer, not only
                continue             # on events (syncflow.go:443-447)
            for group in spec.pod_groups:
                group.pod_references = pods_by_group[group.name]
            if existing is None:
                labels = dict(
                    comp_labels,
                    **{constants.LABEL_PCS_REPLICA_INDEX: str(replica)},
                    **tenant_labels,
                    **extra_labels,
                )
                self.store.create(
                    PodGang(
                        metadata=new_meta(gang_name, ns, pcs, labels), spec=spec
                    ),
                    owned=True,
                )
                self._mark_own()
                if tracer is not None:
                    causal = {}
                    if ledger is not None:
                        link = ledger.follow(("pcs", ns, name))
                        if link is not None:
                            causal["causal_link"] = link
                        causal["causal_emit"] = ledger.emit(
                            ("gang", ns, gang_name)
                        )
                    tracer.point(
                        "pcs.gang_create",
                        gang=f"{ns}/{gang_name}", pcs=name, **causal,
                    )
            elif existing.spec != spec:
                fresh = self.store.get(PodGang.KIND, ns, gang_name)
                fresh.spec = spec
                self.store.update(fresh)
                self._mark_own()
        for gang in self.store.scan(PodGang.KIND, namespace=ns, labels=comp_labels):
            if gang.metadata.name not in expected:
                self.store.delete(PodGang.KIND, ns, gang.metadata.name)
        if not deferred:
            return None
        # the timer-fired retry must re-run the SPEC flow (the status-only
        # flow never reaches this component), or the requeue re-examines
        # nothing
        self._spec_dirty.add((ns, name))
        return self.config.controllers.sync_retry_interval_seconds

    def _compute_expected_podgangs(self, pcs: PodCliqueSet, levels: dict[str, str]):
        """name -> (pcs_replica, PodGangSpec, extra labels). Base gangs per
        PCS replica + scaled gangs per PCSG replica beyond minAvailable
        (syncflow.go:140-259)."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        tmpl = pcs.spec.template
        cliques_by_name = {c.name: c for c in tmpl.cliques}
        in_pcsg = {cn for sg in tmpl.pod_clique_scaling_group_configs
                   for cn in sg.clique_names}
        out: dict[str, tuple[int, PodGangSpec, dict]] = {}
        for i in range(pcs.spec.replicas):
            base_name = naming.base_podgang_name(name, i)
            groups: list[PodGroup] = []
            cgroups: list[TopologyConstraintGroupConfig] = []
            for clique in tmpl.cliques:
                if clique.name in in_pcsg:
                    continue
                groups.append(
                    PodGroup(
                        name=naming.podclique_name(name, i, clique.name),
                        min_replicas=clique.spec.min_available or 1,
                        topology_constraint=_translate(
                            clique.spec.topology_constraint, levels
                        ),
                    )
                )
            for sg in tmpl.pod_clique_scaling_group_configs:
                pcsg_fqn = naming.pcsg_name(name, i, sg.name)
                live = self.store.peek(PodCliqueScalingGroup.KIND, ns, pcsg_fqn)
                replicas = live.spec.replicas if live else (sg.replicas or 1)
                min_avail = live.spec.min_available if live else (sg.min_available or 1)
                base_group_names = []
                for j in range(min(min_avail, replicas)):
                    for cn in sg.clique_names:
                        gname = naming.podclique_name(pcsg_fqn, j, cn)
                        base_group_names.append(gname)
                        groups.append(
                            PodGroup(
                                name=gname,
                                min_replicas=(
                                    cliques_by_name[cn].spec.min_available or 1
                                ),
                                topology_constraint=_translate(
                                    cliques_by_name[cn].spec.topology_constraint,
                                    levels,
                                ),
                            )
                        )
                if sg.topology_constraint is not None and base_group_names:
                    cgroups.append(
                        TopologyConstraintGroupConfig(
                            name=pcsg_fqn,
                            pod_group_names=base_group_names,
                            topology_constraint=_translate(
                                sg.topology_constraint, levels
                            ),
                        )
                    )
                # scaled gangs for replicas beyond minAvailable
                for j in range(min_avail, replicas):
                    scaled_name = naming.scaled_podgang_name(pcsg_fqn, j - min_avail)
                    scaled_groups = [
                        PodGroup(
                            name=naming.podclique_name(pcsg_fqn, j, cn),
                            min_replicas=(
                                cliques_by_name[cn].spec.min_available or 1
                            ),
                            topology_constraint=_translate(
                                cliques_by_name[cn].spec.topology_constraint,
                                levels,
                            ),
                        )
                        for cn in sg.clique_names
                    ]
                    out[scaled_name] = (
                        i,
                        PodGangSpec(
                            pod_groups=scaled_groups,
                            topology_constraint=_translate(
                                sg.topology_constraint, levels
                            ),
                            priority_class_name=tmpl.priority_class_name,
                            # Reservation-reuse hint (podgang.go:66-72 — the
                            # reference declares the field but never sets
                            # it). Recreated gangs keep their name (gang
                            # termination rebuilds the same replica), so the
                            # predecessor whose reservation may be reused is
                            # the prior same-named gang; the scheduler
                            # remembers its placement and tries it first.
                            reuse_reservation_ref=NamespacedName(
                                namespace=ns, name=scaled_name
                            ),
                        ),
                        {constants.LABEL_BASE_PODGANG: base_name},
                    )
            out[base_name] = (
                i,
                PodGangSpec(
                    pod_groups=groups,
                    topology_constraint=_translate(tmpl.topology_constraint, levels),
                    topology_constraint_group_configs=cgroups,
                    priority_class_name=tmpl.priority_class_name,
                    reuse_reservation_ref=NamespacedName(
                        namespace=ns, name=base_name
                    ),
                ),
                {},
            )
        return out

    def _topology_levels(self) -> dict[str, str]:
        """domain -> node-label key from the singleton ClusterTopology."""
        ct = self.store.peek(
            ClusterTopology.KIND, "", "grove-topology"
        ) or self.store.peek(ClusterTopology.KIND, "default", "grove-topology")
        if ct is None:
            return {}
        return {lv.domain: lv.key for lv in ct.spec.levels}

    # -- status flow (reconcilestatus.go) ----------------------------------
    def _reconcile_status(self, pcs: PodCliqueSet) -> None:
        """Reads live state; the write goes through patch_status (clones
        just the status, writes only on change) — this flow runs on every
        enqueued status rollup, so the full-object get() clone here was
        measurable at 10^3-replica scale."""
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        fresh = self.store.peek(KIND, ns, name)
        if fresh is None:
            return
        by_replica = self._constituents_by_replica(ns, name)
        available = 0
        for i in range(fresh.spec.replicas):
            constituents = by_replica.get(i)
            if constituents and all(_constituent_available(o) for o in constituents):
                available += 1
        # TopologyLevelsUnavailable (reconcilestatus.go:174-246)
        missing = self._missing_levels(fresh)
        replicas = fresh.spec.replicas
        now = self.store.clock.now()

        def mutate(status):
            status.replicas = replicas
            status.available_replicas = available
            set_condition(
                status.conditions,
                constants.CONDITION_TOPOLOGY_LEVELS_UNAVAILABLE,
                "True" if missing else "False",
                reason=(
                    "TopologyLevelsMissing" if missing
                    else "TopologyLevelsPresent"
                ),
                message=",".join(missing),
                now=now,
            )
            status.selector = f"{constants.LABEL_PART_OF}={name}"
            clear_status_errors(self.store, status, now)

        self.store.patch_status(KIND, ns, name, mutate)

    def _missing_levels(self, pcs: PodCliqueSet) -> list[str]:
        if not self.config.topology_aware_scheduling.enabled:
            return []  # constraints ignored wholesale, nothing is "missing"
        levels = self._topology_levels()
        tmpl = pcs.spec.template
        wanted: set[str] = set()
        for tc in (
            [tmpl.topology_constraint]
            + [c.spec.topology_constraint for c in tmpl.cliques]
            + [sg.topology_constraint
               for sg in tmpl.pod_clique_scaling_group_configs]
        ):
            if tc is not None and tc.pack_constraint is not None:
                for dom in (tc.pack_constraint.required, tc.pack_constraint.preferred):
                    if dom is not None:
                        wanted.add(dom)
        return sorted(d for d in wanted if d not in levels)


def _constituent_available(obj) -> bool:
    """A PCS-replica constituent counts toward availability only when it is
    actually scheduled AND not breaching MinAvailable (reconcilestatus.go:
    61-172) — a never-scheduled replica is NOT available."""
    breach = get_condition(
        obj.status.conditions, constants.CONDITION_MIN_AVAILABLE_BREACHED
    )
    if breach is not None and breach.status == "True":
        return False
    if isinstance(obj, PodCliqueScalingGroup):
        return obj.status.available_replicas >= obj.spec.min_available
    sched = get_condition(
        obj.status.conditions, constants.CONDITION_PODCLIQUE_SCHEDULED
    )
    return sched is not None and sched.status == "True"


def _translate(
    tc: Optional[TopologyConstraintSpec], levels: Optional[dict[str, str]]
) -> Optional[TopologyConstraint]:
    """Operator-side domain names -> scheduler-contract label keys
    (the KAI Topology CR hand-off in the reference, clustertopology.go:
    141-175; here a direct translation). An unknown PREFERRED domain is
    dropped (best-effort); an unknown REQUIRED domain is passed through as
    an `unresolved:` sentinel key that can never match a snapshot level, so
    the solver marks the gang unschedulable instead of silently scheduling a
    hard constraint unconstrained. The PCS status additionally carries
    TopologyLevelsUnavailable.

    levels=None means topology-aware scheduling is DISABLED by config: all
    constraints are ignored wholesale (the reference deletes the KAI
    Topology CR and stops translating), which is different from an enabled
    system missing one level."""
    if tc is None or tc.pack_constraint is None or levels is None:
        return None
    req = tc.pack_constraint.required
    pref = tc.pack_constraint.preferred
    out = TopologyPackConstraint(
        required=levels.get(req, f"unresolved:{req}") if req else None,
        preferred=levels.get(pref) if pref else None,
    )
    if out.required is None and out.preferred is None:
        return None
    return TopologyConstraint(pack_constraint=out)


def _copy_spec(spec: PodCliqueSpec) -> PodCliqueSpec:
    return clone(spec)


def _shallow_spec(spec: PodCliqueSpec) -> PodCliqueSpec:
    """Independent PodCliqueSpec shell (scalar fields like replicas may be
    written by HPA updates via get-clone-update) sharing the frozen
    template substructure."""
    return _shallow(spec)
