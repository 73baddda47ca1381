"""PodCliqueScalingGroup reconciler.

Mirrors operator/internal/controller/podcliquescalinggroup/: per PCSG
replica j it creates one PodClique per member clique, named
'<pcsgFQN>-<j>-<clique>' with labels carrying the PCSG replica index and —
for replicas beyond minAvailable — the grove.io/base-podgang label that
makes the pod component hold scaled-gang pods until the base gang is
scheduled (components/podclique/podclique.go:287,422-443). Scale-in
deletes the highest replica indices first. Status aggregates per-replica
scheduled/available and raises MinAvailableBreached when fewer than
minAvailable replicas are healthy (reconcilestatus.go:83-207).
"""

from __future__ import annotations


from ..api import constants, naming
from ..api.meta import get_condition, set_condition
from ..api.types import (
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueSet,
)
from ..cluster.store import Event, ObjectStore, clone
from ..observability.events import EventRecorder
from .common import base_labels, new_meta
from .podcliqueset import _shallow_spec
from .errors import (
    ERR_SYNC_FAILED,
    GroveError,
    clear_status_errors,
    record_status_error,
)
from .runtime import Request, Result

KIND = PodCliqueScalingGroup.KIND


class PCSGReconciler:
    name = "podcliquescalinggroup"
    watch_kinds = frozenset(
        (KIND, PodClique.KIND, "Pod", PodCliqueSet.KIND)
    )

    def __init__(self, store: ObjectStore):
        self.store = store
        self.recorder = EventRecorder(store, controller=self.name)
        #: PCSGs with a rollout in flight: only then do POD events feed
        #: this reconciler (clique_updated reads pod hashes/readiness);
        #: outside rollouts pod churn is the PodClique controller's job.
        #: The generation-change predicate analog, like the PCS/PodClique
        #: reconcilers.
        self._rollout_active: set[tuple[str, str]] = set()
        #: own-write event echoes (clique creates/spec updates) — the
        #: expectations analog; deletes stay live (scale-in rides them)
        self._own_events: set[int] = set()

    def _mark_own(self) -> None:
        self._own_events.add(self.store.last_seq)
        if len(self._own_events) > 100_000:  # safety: undrained leak
            self._own_events.clear()

    def record_error(self, request: Request, err: GroveError) -> None:
        """Every kind surfaces its own controller errors
        (scalinggroup.go:94-95)."""
        record_status_error(
            self.store, KIND, request.namespace, request.name, err
        )

    def map_events(self, events, enqueue) -> None:
        """Batched watch predicate (one call per drain round; the
        runtime hands over only watch_kinds events). Pod events are the
        bulk of a settle drain and almost always irrelevant here (they
        only matter mid-rollout), so the batched path's cheap label +
        rollout-set test replaces a per-event Python call + list return
        that was measurable at 10^4-event scale. map_event remains the
        single-event view for direct callers/tests."""
        name_ = self.name
        rollout_active = self._rollout_active
        for event in events:
            if event.kind == "Pod":
                if not rollout_active:
                    continue
                pcsg = event.obj.metadata.labels.get(constants.LABEL_PCSG)
                if pcsg and (event.namespace, pcsg) in rollout_active:
                    enqueue(name_, Request(event.namespace, pcsg))
                continue
            for req in self.map_event(event):
                enqueue(name_, req)

    def map_event(self, event: Event) -> list[Request]:
        if event.kind == KIND:
            # own status writes / metadata-only bumps feed nothing here
            if (
                event.type == "Modified"
                and event.old is not None
                and event.obj.metadata.generation
                == event.old.metadata.generation
                and event.obj.metadata.deletion_timestamp
                == event.old.metadata.deletion_timestamp
            ):
                return []
            return [Request(event.namespace, event.name)]
        if event.kind == PodClique.KIND:
            if event.seq in self._own_events:
                self._own_events.discard(event.seq)
                return []
            pcsg = event.obj.metadata.labels.get(constants.LABEL_PCSG)
            if pcsg:
                return [Request(event.namespace, pcsg)]
            return []
        if event.kind == "Pod":
            # pods only matter while a rollout is advancing (hash/ready
            # checks in clique_updated); clique status events carry the
            # availability rollup otherwise
            pcsg = event.obj.metadata.labels.get(constants.LABEL_PCSG)
            if pcsg and (event.namespace, pcsg) in self._rollout_active:
                return [Request(event.namespace, pcsg)]
            return []
        if event.kind == PodCliqueSet.KIND:
            # the PCS rolling update pointing at this PCSG's replica is a
            # status-level trigger (reconcilespec.go:70-117); only spec
            # changes or rolling-progress movement matter — names only,
            # no-copy scan
            if (
                event.type == "Modified"
                and event.old is not None
                and event.obj.metadata.generation
                == event.old.metadata.generation
                and event.obj.status.rolling_update_progress
                == event.old.status.rolling_update_progress
            ):
                return []
            return [
                Request(event.namespace, g.metadata.name)
                for g in self.store.scan(
                    KIND,
                    namespace=event.namespace,
                    labels={constants.LABEL_PART_OF: event.name},
                )
            ]
        return []

    def reconcile(self, request: Request) -> Result:
        pcsg = self.store.get(KIND, request.namespace, request.name)
        if pcsg is None:
            return Result()
        if pcsg.metadata.deletion_timestamp is not None:
            return self._reconcile_delete(pcsg)
        self.store.add_finalizer(
            KIND, request.namespace, request.name, constants.FINALIZER_PCSG
        )
        self._sync_rolling_update(pcsg)
        # pod events feed this reconciler only while a rollout advances
        # (see map_event); track it off the just-written live status
        key = (request.namespace, request.name)
        live = self.store.peek(KIND, request.namespace, request.name)
        prog = live.status.rolling_update_progress if live else None
        if prog is not None and not prog.completed:
            self._rollout_active.add(key)
        else:
            self._rollout_active.discard(key)
        self._sync_podcliques(pcsg)
        self._reconcile_status(pcsg)
        return Result()

    def _sync_rolling_update(self, pcsg: PodCliqueScalingGroup) -> None:
        """Replica-at-a-time rollout, active only while the owning PCS's
        rolling update points at THIS PCSG's PCS replica
        (reconcilespec.go:70-117)."""
        from ..api.types import PCSGRollingUpdateProgress
        from .updates import (
            clique_template_hashes,
            clique_updated,
            prune_vanished_replicas,
        )

        pcs = self._owner_pcs(pcsg)
        if pcs is None:
            return
        pcs_prog = pcs.status.rolling_update_progress
        my_pcs_replica = int(
            pcsg.metadata.labels.get(constants.LABEL_PCS_REPLICA_INDEX, -1)
        )
        points_at_me = (
            pcs_prog is not None
            and not pcs_prog.completed
            and pcs_prog.current_replica_index == my_pcs_replica
        )
        status = pcsg.status
        before = clone(status)
        prog = status.rolling_update_progress
        if prog is None or (
            pcs_prog is not None
            and prog.target_generation_hash != pcs_prog.target_generation_hash
        ):
            # INITIATION is gated on the PCS update pointing at this PCSG's
            # replica; an already-started update toward the SAME target
            # keeps advancing after the PCS moves on (it only moves on once
            # our pods are rolled — the bookkeeping must still land). A
            # stale update toward an OLD target is abandoned so
            # _sync_podcliques stops propagating outside orchestration.
            if not points_at_me:
                if prog is not None and not prog.completed:
                    status.rolling_update_progress = None
                    if status != before:
                        self.store.update_status(pcsg)
                return
            prog = status.rolling_update_progress = PCSGRollingUpdateProgress(
                target_generation_hash=pcs_prog.target_generation_hash
            )
        if prog.completed:
            return
        target = prog.target_generation_hash
        hashes = clique_template_hashes(pcs)
        prune_vanished_replicas(prog, pcsg.spec.replicas)
        if prog.current_replica_index is not None:
            j = prog.current_replica_index
            pclqs = self._replica_pclqs(pcsg, j)
            done = bool(pclqs) and all(
                clique_updated(
                    self.store,
                    pclq,
                    hashes.get(
                        pclq.metadata.labels.get(constants.LABEL_CLIQUE_TEMPLATE, ""),
                        "",
                    ),
                )
                for pclq in pclqs
            )
            if done:
                prog.updated_replica_indices.append(j)
                prog.current_replica_index = None
        if prog.current_replica_index is None:
            remaining = [
                j
                for j in range(pcsg.spec.replicas)
                if j not in prog.updated_replica_indices
            ]
            if not remaining:
                prog.completed = True
                status.current_generation_hash = target
            else:
                prog.current_replica_index = min(remaining)
        status.updated_replicas = len(prog.updated_replica_indices)
        if status != before:
            self.store.update_status(pcsg)

    def _replica_pclqs(self, pcsg: PodCliqueScalingGroup, j: int) -> list[PodClique]:
        return [
            p
            for p in self._owned_pclqs(pcsg)
            if p.metadata.labels.get(constants.LABEL_PCSG_REPLICA_INDEX) == str(j)
        ]

    def _reconcile_delete(self, pcsg: PodCliqueScalingGroup) -> Result:
        self._rollout_active.discard(
            (pcsg.metadata.namespace, pcsg.metadata.name)
        )
        ns = pcsg.metadata.namespace
        for pclq in self._owned_pclqs(pcsg):
            if pclq.metadata.deletion_timestamp is None:
                self.store.delete(PodClique.KIND, ns, pclq.metadata.name)
        self.store.remove_finalizer(
            KIND, ns, pcsg.metadata.name, constants.FINALIZER_PCSG
        )
        return Result()

    def _owned_pclqs(self, pcsg: PodCliqueScalingGroup) -> list[PodClique]:
        """Read-only scan: callers inspect labels/conditions and act
        through the store API."""
        return self.store.scan(
            PodClique.KIND,
            namespace=pcsg.metadata.namespace,
            labels={constants.LABEL_PCSG: pcsg.metadata.name},
        )

    def _owner_pcs(self, pcsg: PodCliqueScalingGroup) -> PodCliqueSet | None:
        name = pcsg.metadata.labels.get(constants.LABEL_PART_OF)
        if not name:
            return None
        # read-only peek: callers read template/rolling progress only
        return self.store.peek(
            PodCliqueSet.KIND, pcsg.metadata.namespace, name
        )

    def _sync_podcliques(self, pcsg: PodCliqueScalingGroup) -> None:
        pcs = self._owner_pcs(pcsg)
        if pcs is None:
            # A live PCSG always has an owning PCS; not seeing it is
            # informer lag (or a racing cascade delete). Returning
            # silently here starves the member cliques forever when no
            # later event re-enqueues this PCSG — fail the reconcile and
            # let the backoff retry re-read.
            raise GroveError(
                ERR_SYNC_FAILED,
                f"pcsg:{pcsg.metadata.namespace}/{pcsg.metadata.name}",
                "owning PodCliqueSet not visible; deferring clique sync",
            )
        ns = pcsg.metadata.namespace
        fqn = pcsg.metadata.name
        pcs_name = pcs.metadata.name
        pcs_replica = pcsg.metadata.labels.get(constants.LABEL_PCS_REPLICA_INDEX, "0")
        templates = {c.name: c for c in pcs.spec.template.cliques}
        min_avail = pcsg.spec.min_available
        expected: dict[str, tuple[int, str]] = {}
        for j in range(pcsg.spec.replicas):
            for clique_name in pcsg.spec.clique_names:
                expected[naming.podclique_name(fqn, j, clique_name)] = (j, clique_name)
        comp_labels = dict(
            base_labels(pcs_name),
            **{constants.LABEL_COMPONENT: constants.COMPONENT_PCSG_PODCLIQUE},
        )
        prog = pcsg.status.rolling_update_progress
        updating_replica = (
            prog.current_replica_index
            if prog is not None and not prog.completed
            else None
        )
        for pclq_name, (j, clique_name) in expected.items():
            template = templates.get(clique_name)
            existing = self.store.peek(PodClique.KIND, ns, pclq_name)
            if existing is not None:
                if j == updating_replica and template is not None:
                    new_spec = clone(template.spec)
                    new_spec.replicas = existing.spec.replicas
                    if existing.spec != new_spec:
                        fresh = self.store.get(PodClique.KIND, ns, pclq_name)
                        fresh.spec = new_spec
                        self.store.update(fresh)
                        self._mark_own()
                continue
            if template is None:
                continue
            gang = naming.podgang_name_for_pcsg_replica(
                pcs_name, int(pcs_replica), fqn, j, min_avail
            )
            labels = dict(
                comp_labels,
                **{
                    constants.LABEL_PCS_REPLICA_INDEX: pcs_replica,
                    constants.LABEL_PCSG: fqn,
                    constants.LABEL_PCSG_REPLICA_INDEX: str(j),
                    constants.LABEL_PODGANG: gang,
                    constants.LABEL_CLIQUE_TEMPLATE: clique_name,
                },
            )
            if j >= min_avail:  # scaled replica -> gate on base gang
                labels[constants.LABEL_BASE_PODGANG] = naming.base_podgang_name(
                    pcs_name, int(pcs_replica)
                )
            self.store.create(
                PodClique(
                    metadata=new_meta(pclq_name, ns, pcsg, labels),
                    # frozen-template sharing, as in the PCS podclique
                    # component (see podcliqueset._shallow_spec)
                    spec=_shallow_spec(template.spec),
                ),
                owned=True,
            )
            self._mark_own()
        # scale-in: drop highest replica indices (components/podclique/
        # podclique.go scale-in path)
        for pclq in self._owned_pclqs(pcsg):
            if pclq.metadata.name not in expected:
                self.store.delete(PodClique.KIND, ns, pclq.metadata.name)

    def _reconcile_status(self, pcsg: PodCliqueScalingGroup) -> None:
        fresh = self.store.get(KIND, pcsg.metadata.namespace, pcsg.metadata.name)
        if fresh is None:
            return
        status = fresh.status
        before = clone(status)
        pclqs = self._owned_pclqs(fresh)
        by_replica: dict[int, list[PodClique]] = {}
        for pclq in pclqs:
            j = int(pclq.metadata.labels.get(constants.LABEL_PCSG_REPLICA_INDEX, 0))
            by_replica.setdefault(j, []).append(pclq)
        scheduled = available = 0
        for j, group in by_replica.items():
            if len(group) < len(fresh.spec.clique_names):
                continue
            if all(
                _cond_true(p, constants.CONDITION_PODCLIQUE_SCHEDULED) for p in group
            ):
                scheduled += 1
                if not any(
                    _cond_true(p, constants.CONDITION_MIN_AVAILABLE_BREACHED)
                    for p in group
                ):
                    available += 1
        if before.replicas and fresh.spec.replicas != before.replicas:
            # the scale subresource moved (HPA write, manual resize):
            # surface it as an Event so the elastic-serving runbook's
            # `kubectl get events` analog shows the scale loop acting
            # (docs/operations.md "Elastic serving")
            self.recorder.normal(
                fresh,
                "ScalingGroupResized",
                f"replicas {before.replicas} -> {fresh.spec.replicas}",
            )
        status.replicas = fresh.spec.replicas
        status.scheduled_replicas = scheduled
        status.available_replicas = available
        status.observed_generation = fresh.metadata.generation
        status.selector = f"{constants.LABEL_PCSG}={fresh.metadata.name}"
        now = self.store.clock.now()
        breached = scheduled >= fresh.spec.min_available and (
            available < fresh.spec.min_available
        )
        set_condition(
            status.conditions,
            constants.CONDITION_MIN_AVAILABLE_BREACHED,
            "True" if breached else "False",
            reason=(
                constants.REASON_INSUFFICIENT_READY_PODS
                if breached
                else constants.REASON_SUFFICIENT_READY_PODS
            ),
            now=now,
        )
        clear_status_errors(self.store, status, now)
        if status != before:
            self.store.update_status(fresh)


def _cond_true(obj, cond_type: str) -> bool:
    cond = get_condition(obj.status.conditions, cond_type)
    return cond is not None and cond.status == "True"
