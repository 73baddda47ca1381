"""PodClique reconciler: owns Pods.

Mirrors operator/internal/controller/podclique/ + components/pod/: the pod
component computes an expectations-corrected diff, creates pods SCHEDULING
GATED (grove.io/podgang-pending-creation, pod.go:68,162) with hole-filling
hostname indices (index/tracker.go), Grove env vars (pod.go:227-254),
hostname/subdomain for per-replica DNS (pod.go:257-264) and the
startup-order dependency annotation (the init-container injection point,
initcontainer.go:51-158). Gate removal (syncflow.go:242-394): a pod's gate
drops only once the pod is referenced in its PodGang; pods of SCALED gangs
additionally wait until the BASE PodGang reports scheduled.

Status flow (reconcilestatus.go): replica counts incl. scheduled/gated,
PodCliqueScheduled, and MinAvailableBreached — where a pod that started
and never crashed still counts as healthy (:176-225).
"""

from __future__ import annotations


from ..api import constants, naming
from ..api.meta import get_condition, set_condition
from ..api.podgang import PodGang
from ..api.types import (
    CliqueStartupType,
    Pod,
    PodClique,
    PodCliqueRollingUpdateProgress,
    PodCliqueSet,
    PodPhase,
)
from ..cluster.store import Event, ObjectStore, _shallow
from .common import is_pod_active, is_pod_healthy, new_meta, stable_hash
from .concurrency import run_with_slow_start
from ..observability.events import EventRecorder, REASON_CREATE_SUCCESSFUL
from .errors import (
    ERR_SYNC_FAILED,
    GroveError,
    clear_status_errors,
    record_status_error,
)
from .runtime import Request, Result

KIND = PodClique.KIND


class PodCliqueReconciler:
    name = "podclique"
    watch_kinds = frozenset((KIND, Pod.KIND, PodGang.KIND))

    def __init__(self, store: ObjectStore, retry_seconds: float = 5.0):
        self.store = store
        #: pacing for the gated-pods self-requeue (see reconcile): the
        #: sync_retry_interval_seconds the harness wires through
        self.retry_seconds = retry_seconds
        self.recorder = EventRecorder(store, controller=self.name)
        #: clique keys whose next reconcile must run the pod component
        #: (_sync_pods: diff/replace/gates). The generation-change
        #: predicate analog: pod phase/readiness churn only needs the
        #: status flow — at 10^4-pod scale the pod component re-running
        #: per status event dominated settle wall-clock.
        self._pods_dirty: set[tuple[str, str]] = set()
        #: cliques with a pod-template rollout in flight: readiness flips
        #: drive _rolling_replace forward there, so they re-run the pod
        #: component on every pod event until the rollout completes
        #: (maintained by _reconcile_status, which computes outdated pods)
        self._rollout_active: set[tuple[str, str]] = set()
        #: event seqs of this reconciler's own pod CREATES and UNGATES.
        #: The expectations-store analog (the reference uses
        #: internal/expect/ to not re-act on its own writes through a
        #: stale informer): the reconcile that made the write already ran
        #: the status flow over the result, so the echoed event needs no
        #: further reconcile. Deletes are deliberately NOT suppressed —
        #: the delete->recreate chain (failed-pod replacement, rolling
        #: updates) rides the Deleted event. Consumed on sight;
        #: single-threaded store, so store.last_seq right after a write IS
        #: that write's event.
        self._own_events: set[int] = set()
        #: per-key count of reconciles that found the clique NOT VISIBLE
        #: while pod work was pending. A just-recreated clique (gang
        #: restart) can be hidden from peek by informer lag — returning
        #: success there would eat the dirty bit and starve the clique
        #: with zero pods (no pod ever exists to emit a wakeup event).
        #: Bounded: a genuinely deleted clique stops retrying when its
        #: Deleted event clears the key (map_events), or after
        #: NOT_VISIBLE_RETRIES at the latest.
        self._not_visible: dict[tuple[str, str], int] = {}

    #: retries for a dirty-but-not-visible clique before concluding it is
    #: genuinely gone (each retry is retry_seconds — and many store
    #: events — later, so a lagging read has long since caught up)
    NOT_VISIBLE_RETRIES = 3

    def record_error(self, request: Request, err: GroveError) -> None:
        """Every kind surfaces its own controller errors
        (podclique.go:107-108)."""
        record_status_error(
            self.store, KIND, request.namespace, request.name, err
        )

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
        pods_dirty = self._pods_dirty
        own = self._own_events
        rollout_active = self._rollout_active
        for event in events:
            kind = event.kind
            if kind == KIND:
                # the clique's own status writes (and metadata-only bumps
                # like finalizers) feed nothing this reconciler computes —
                # only spec changes, lifecycle edges and deletion marks do
                if (
                    event.type == "Modified"
                    and event.old is not None
                    and event.obj.metadata.generation
                    == event.old.metadata.generation
                    and event.obj.metadata.deletion_timestamp
                    == event.old.metadata.deletion_timestamp
                ):
                    continue
                key = (event.namespace, event.name)
                if event.type == "Deleted":
                    # final store deletion: cleanup already ran in
                    # _reconcile_delete, so there is nothing to reconcile
                    # — and the not-visible retry loop (see reconcile)
                    # must stop now, not at its bound
                    pods_dirty.discard(key)
                    self._not_visible.pop(key, None)
                    continue
                pods_dirty.add(key)
                enqueue(name_, Request(event.namespace, event.name))
            elif kind == Pod.KIND:
                if event.seq in own:
                    # our own write, already rolled up by the reconcile
                    # that made it (expectations analog — see __init__)
                    own.discard(event.seq)
                    continue
                pclq = event.obj.metadata.labels.get(
                    constants.LABEL_PODCLIQUE
                )
                if not pclq:
                    continue
                key = (event.namespace, pclq)
                # pod component triggers: inventory changes (add/delete),
                # spec changes (ungate bumps generation), active-ness
                # flips (Failed/Succeeded pods get replaced). Pure phase/
                # readiness churn only rolls up counts — unless a rollout
                # is in flight, where readiness gates the next
                # pod-at-a-time replacement.
                if (
                    event.type != "Modified"
                    or event.old is None
                    or event.obj.metadata.generation
                    != event.old.metadata.generation
                    or is_pod_active(event.obj) != is_pod_active(event.old)
                    or (
                        key in rollout_active
                        and event.obj.status.ready != event.old.status.ready
                    )
                ):
                    pods_dirty.add(key)
                enqueue(name_, Request(event.namespace, pclq))
            elif kind == PodGang.KIND:
                # Gang creation/scheduling unblocks gate removal
                # (register.go:49-120) — but only for cliques the gang
                # actually references: its PodGroups are named after them,
                # plus the scaled cliques holding this gang as their base.
                # Mapping to every clique of the PCS (the r2 shape) turned
                # each gang status write into an O(cliques) reconcile
                # fan-out — the control-plane bottleneck at 1000-replica
                # scale.
                #
                # Gate relevance (syncflow.go:242-394): a gang's EXISTENCE
                # and pod_references (spec) gate its own cliques' pods;
                # its SCHEDULED condition gates pods of scaled gangs based
                # on it. Phase/score churn gates nothing — no reconcile.
                ns = event.namespace
                spec_changed = (
                    event.type != "Modified" or event.old is None or (
                        event.obj.metadata.generation
                        != event.old.metadata.generation
                    )
                )
                scheduled_changed = spec_changed or _is_scheduled(
                    event.obj
                ) != _is_scheduled(event.old)
                if not spec_changed and not scheduled_changed:
                    continue
                if spec_changed:
                    for group in event.obj.spec.pod_groups:
                        pods_dirty.add((ns, group.name))
                        enqueue(name_, Request(ns, group.name))
                if scheduled_changed:
                    base_of = event.obj.metadata.name
                    for p in self.store.scan(  # names only: no-copy scan
                        KIND,
                        namespace=ns,
                        labels={constants.LABEL_BASE_PODGANG: base_of},
                    ):
                        pods_dirty.add((ns, p.metadata.name))
                        enqueue(name_, Request(ns, p.metadata.name))

    def reconcile(self, request: Request) -> Result:
        # peek: this reconciler never mutates the PodClique object itself —
        # every write goes through a dedicated store call (pod CRUD,
        # finalizers, patch_status) — and the per-reconcile get() clone of
        # the whole clique dominated settle at 10^3-clique scale
        key = (request.namespace, request.name)
        pods_dirty = key in self._pods_dirty
        self._pods_dirty.discard(key)
        try:
            pclq = self.store.peek(KIND, request.namespace, request.name)
            if pclq is None:
                # Not visible ≠ deleted: a just-recreated clique (gang
                # restart) can be hidden by informer lag, and dropping the
                # dirty bit here starves it at zero pods forever — no pod
                # exists to ever wake this reconciler again. Restore the
                # bit and retry on the timer; a genuine deletion ends the
                # loop via its Deleted event (map_events) or the bound.
                if pods_dirty:
                    seen = self._not_visible.get(key, 0)
                    if seen < self.NOT_VISIBLE_RETRIES:
                        self._not_visible[key] = seen + 1
                        self._pods_dirty.add(key)
                        return Result(requeue_after=self.retry_seconds)
                self._not_visible.pop(key, None)
                return Result()
            self._not_visible.pop(key, None)
            if pclq.metadata.deletion_timestamp is not None:
                return self._reconcile_delete(pclq)
            self.store.add_finalizer(
                KIND, request.namespace, request.name,
                constants.FINALIZER_PCLQ
            )
            if pods_dirty:
                self._sync_pods(pclq)
            gated, under = self._reconcile_status(pclq)
        except BaseException:
            # The retry (backoff requeue, or a relist after a manager
            # crash) must re-run the pod component. Guarding only
            # _sync_pods lost the dirty bit when add_finalizer or the
            # status flow raised — the retry then ran the cheap path,
            # "succeeded", and the clique starved with zero pods.
            if pods_dirty:
                self._pods_dirty.add(key)
            raise
        if gated or under:
            # A pod still gated means _remove_gates deferred on state that
            # may have been a stale read (gang not visible yet, base gang
            # not Scheduled yet). Waiting ONLY for the next watch event
            # starves when the state already changed before this reconcile
            # consumed its event — so a gated pod always arms the retry
            # timer, and the retry re-runs the pod component. (The count
            # rides along from _reconcile_status's single pod pass — no
            # second owned-pods scan on this per-pod-event hot path.)
            #
            # UNDER-replication arms the same timer: the status flow saw
            # fewer active pods than spec. Either pods are genuinely
            # missing (the retry re-runs _sync_pods and creates them) or
            # a stale read hid pods this reconcile itself created — whose
            # echoed events are suppressed as our own writes, so no event
            # will ever re-wake us and the rollup would wedge below spec
            # forever (node-fault chaos seed; same shape as the
            # not-visible-with-pending-work starvation).
            self._pods_dirty.add(key)
            return Result(requeue_after=self.retry_seconds)
        return Result()

    def _reconcile_delete(self, pclq: PodClique) -> Result:
        ns = pclq.metadata.namespace
        # hole-filled names recur after scale-in/out: a stale rollout
        # entry would misclassify the successor's readiness churn
        self._rollout_active.discard((ns, pclq.metadata.name))
        self._pods_dirty.discard((ns, pclq.metadata.name))
        for pod in self._owned_pods(pclq):
            if pod.metadata.deletion_timestamp is None:
                self.store.delete(Pod.KIND, ns, pod.metadata.name)
        self.store.remove_finalizer(
            KIND, ns, pclq.metadata.name, constants.FINALIZER_PCLQ
        )
        return Result()

    def _mark_own(self) -> None:
        """Record the event seq of a pod write this reconciler just made
        (see _own_events). Bounded: consumed at the next drain."""
        self._own_events.add(self.store.last_seq)
        if len(self._own_events) > 100_000:  # safety: undrained leak
            self._own_events.clear()

    def _owned_pods(self, pclq: PodClique) -> list[Pod]:
        """Read-only scan (live references): callers decide and then act
        through the store API (create/delete/get-then-update) — they never
        mutate these objects directly."""
        return self.store.scan(
            Pod.KIND,
            namespace=pclq.metadata.namespace,
            labels={constants.LABEL_PODCLIQUE: pclq.metadata.name},
        )

    # -- pod component (components/pod/) -----------------------------------
    def _sync_pods(self, pclq: PodClique) -> None:
        ns = pclq.metadata.namespace
        pods = self._owned_pods(pclq)
        # replace evicted/failed pods (categorization pod.go:183)
        active: list[Pod] = []
        for pod in pods:
            if pod.status.phase in (PodPhase.FAILED, PodPhase.SUCCEEDED):
                self.store.delete(Pod.KIND, ns, pod.metadata.name)
            elif pod.metadata.deletion_timestamp is None:
                active.append(pod)
        want = pclq.spec.replicas
        if len(active) < want:
            self._create_pods(pclq, active, want - len(active))
        elif len(active) > want:
            self._delete_excess(pclq, active, len(active) - want)
        else:
            self._rolling_replace(pclq, active)
        self._remove_gates(pclq)

    def _rolling_replace(self, pclq: PodClique, active: list[Pod]) -> None:
        """Pod-at-a-time template rollout (components/pod/rollingupdate.go:
        73-253): pods whose template-hash label doesn't match the clique's
        current pod template are outdated. Not-yet-ready outdated pods are
        replaced immediately; ready outdated pods one at a time, and only
        while every other pod is ready (no availability dip beyond one)."""
        current = stable_hash(pclq.spec.pod_spec)
        outdated = [
            p
            for p in active
            if p.metadata.labels.get(constants.LABEL_POD_TEMPLATE_HASH) != current
        ]
        if not outdated:
            return
        ns = pclq.metadata.namespace
        not_ready = [p for p in outdated if not p.status.ready]
        if not_ready:
            for pod in not_ready:
                self.store.delete(Pod.KIND, ns, pod.metadata.name)
            return
        if all(p.status.ready for p in active):
            victim = max(
                outdated,
                key=lambda p: int(p.metadata.labels.get(constants.LABEL_POD_INDEX, 0)),
            )
            self.store.delete(Pod.KIND, ns, victim.metadata.name)

    def _create_pods(self, pclq: PodClique, active: list[Pod], count: int) -> None:
        """Hole-filling indices (index/tracker.go:37-60) + gated creation."""
        used = {
            int(p.metadata.labels.get(constants.LABEL_POD_INDEX, -1)) for p in active
        }
        free_indices = [i for i in range(pclq.spec.replicas + len(active) + count)
                        if i not in used][:count]
        pcs = self._owner_pcs(pclq)
        if pcs is None and pclq.metadata.labels.get(constants.LABEL_PART_OF):
            # The owning PCS not being visible is informer lag (or a
            # racing cascade delete), never a license to build pods from
            # a None template context — that would silently drop the
            # startup-barrier annotation and identity env. Fail the
            # reconcile; the backoff retry re-reads (or finds the clique
            # itself gone).
            raise GroveError(
                ERR_SYNC_FAILED,
                f"podclique:{pclq.metadata.namespace}/{pclq.metadata.name}",
                "owning PodCliqueSet not visible; deferring pod builds",
            )
        sg_num_pods = self._pcsg_template_num_pods(pclq, pcs)
        ctx = self._pod_template_ctx(pclq, pcs, sg_num_pods)
        # slow-start pacing (utils/concurrent.go:72-105): a failing
        # admission/authz hook sees one probe create, not the whole diff;
        # the skipped remainder is recomputed idempotently on retry
        result = run_with_slow_start(
            [
                (
                    naming.pod_name(pclq.metadata.name, idx),
                    lambda idx=idx: (
                        self.store.create(
                            self._build_pod(pclq, idx, ctx),
                            owned=True,
                        ),
                        self._mark_own(),
                    ),
                )
                for idx in free_indices
            ]
        )
        if result.succeeded:
            self.recorder.normal(
                pclq,
                REASON_CREATE_SUCCESSFUL,
                f"created {len(result.succeeded)} pod(s) (scheduling gated)",
            )
        result.raise_if_errors("ERR_CREATE_PODS", "create")

    def _pcsg_template_num_pods(
        self, pclq: PodClique, pcs: PodCliqueSet | None
    ) -> int | None:
        """Total pods in one PCSG replica template: sum of member-clique
        replicas (pcsg/components/podclique/podclique.go:214-228). None when
        the clique is not PCSG-owned. Constant per clique, so computed once
        per create batch, not per pod."""
        if pcs is None or not pclq.metadata.labels.get(constants.LABEL_PCSG):
            return None
        tmpl = self._template_name(pclq)
        by_name = {c.name: c for c in pcs.spec.template.cliques}
        for sg in pcs.spec.template.pod_clique_scaling_group_configs:
            if tmpl in sg.clique_names:
                return sum(
                    by_name[cn].spec.replicas
                    for cn in sg.clique_names
                    if cn in by_name
                )
        return None

    def _pod_template_ctx(
        self, pclq: PodClique, pcs: PodCliqueSet | None,
        sg_num_pods: int | None
    ) -> dict:
        """Everything about a pod build that is CONSTANT across one create
        batch (labels base, annotations, env base, DNS identity) — computed
        once per batch, not once per pod (pod.go:227-264 equivalents)."""
        ns = pclq.metadata.namespace
        pcs_name = pclq.metadata.labels.get(constants.LABEL_PART_OF, "")
        replica = pclq.metadata.labels.get(constants.LABEL_PCS_REPLICA_INDEX, "0")
        labels = {
            k: v
            for k, v in pclq.metadata.labels.items()
            if k.startswith("grove.io/") or k.startswith("app.kubernetes.io/")
        }
        labels[constants.LABEL_PODCLIQUE] = pclq.metadata.name
        labels[constants.LABEL_POD_TEMPLATE_HASH] = stable_hash(pclq.spec.pod_spec)
        annotations = {}
        deps = self._startup_deps(pclq, pcs)
        if deps:
            annotations[constants.ANNOTATION_WAIT_FOR] = ",".join(
                f"{fqn}:{minav}" for fqn, minav in deps
            )
        env = {
            constants.ENV_PCS_NAME: pcs_name,
            constants.ENV_PCS_INDEX: replica,
            constants.ENV_PCLQ_NAME: pclq.metadata.name,
            constants.ENV_HEADLESS_SERVICE: naming.headless_service_address(
                pcs_name, int(replica), ns
            ),
        }
        pcsg = pclq.metadata.labels.get(constants.LABEL_PCSG)
        if pcsg:
            env[constants.ENV_PCSG_NAME] = pcsg
            env[constants.ENV_PCSG_INDEX] = pclq.metadata.labels.get(
                constants.LABEL_PCSG_REPLICA_INDEX, "0"
            )
            # total pods in one PCSG replica template — lets a sharded
            # workload size its world from env alone
            if sg_num_pods is not None:
                env[constants.ENV_PCSG_TEMPLATE_NUM_PODS] = str(sg_num_pods)
        sa = ""
        if pcs_name and not pclq.spec.pod_spec.service_account_name:
            # the per-PCS identity whose Role grants the startup-barrier
            # watcher its pod list/watch (components/satokensecret/)
            sa = f"{pcs_name}-sa"
        return {
            "ns": ns,
            "labels": labels,
            "annotations": annotations,
            "env": env,
            "subdomain": naming.headless_service_name(pcs_name, int(replica)),
            "service_account": sa,
        }

    def _build_pod(self, pclq: PodClique, idx: int, ctx: dict) -> Pod:
        ns = ctx["ns"]
        pod_name = naming.pod_name(pclq.metadata.name, idx)
        labels = dict(ctx["labels"])
        labels[constants.LABEL_POD_INDEX] = str(idx)
        # Structural sharing instead of a deep template clone: the stored
        # clique's pod_spec is FROZEN (every store write replaces, never
        # mutates — MVCC), so the pod spec shares its substructure and only
        # replaces what differs per pod: gates, identity fields, and each
        # container (shallow) with its merged env dict. At 10^4-pod settle
        # scale the per-pod deep clone here was a top host cost.
        spec = _shallow(pclq.spec.pod_spec)
        spec.scheduling_gates = [constants.PODGANG_PENDING_CREATION_GATE]
        spec.hostname = pod_name
        spec.subdomain = ctx["subdomain"]
        if ctx["service_account"]:
            spec.service_account_name = ctx["service_account"]
        env = dict(ctx["env"])
        env[constants.ENV_PCLQ_POD_INDEX] = str(idx)
        containers = []
        for container in spec.containers:
            c = _shallow(container)
            c.env = {**container.env, **env}
            containers.append(c)
        spec.containers = containers
        return Pod(
            metadata=new_meta(pod_name, ns, pclq, labels, ctx["annotations"]),
            spec=spec,
        )

    def _startup_deps(
        self, pclq: PodClique, pcs: PodCliqueSet | None
    ) -> list[tuple[str, int]]:
        """Parent-clique dependencies -> (pclq FQN, minAvailable) pairs —
        what the reference turns into grove-initc args
        (initcontainer.go:144-160). FQN resolution follows
        GenerateDependencyNamesForBasePodGang (component/utils/
        podcliquescalinggroup.go:70-83): a parent inside a PCSG resolves to
        that group's base replicas [0, minAvailable); a standalone parent to
        '<pcs>-<i>-<parent>'. Pods of SCALED PCSG replicas only order within
        their own replica and skip cross-group parents
        (pcsg podclique.go:391-408)."""
        if pcs is None:
            return []
        tmpl = pcs.spec.template
        my_template = self._template_name(pclq)
        by_name = {c.name: c for c in tmpl.cliques}
        order = [c.name for c in tmpl.cliques]
        if my_template not in by_name:
            return []
        if tmpl.startup_type == CliqueStartupType.IN_ORDER:
            pos = order.index(my_template)
            parents = [order[pos - 1]] if pos > 0 else []
        elif tmpl.startup_type == CliqueStartupType.EXPLICIT:
            parents = list(by_name[my_template].spec.starts_after)
        else:
            return []
        if not parents:
            return []
        pcs_name = pcs.metadata.name
        pcs_replica = int(
            pclq.metadata.labels.get(constants.LABEL_PCS_REPLICA_INDEX, 0)
        )
        sg_of = {
            cn: sg
            for sg in tmpl.pod_clique_scaling_group_configs
            for cn in sg.clique_names
        }
        my_sg = sg_of.get(my_template)
        my_sg_replica = int(
            pclq.metadata.labels.get(constants.LABEL_PCSG_REPLICA_INDEX, -1)
        )
        scaled = (
            my_sg is not None
            and my_sg_replica >= (my_sg.min_available or 1)
        )
        deps: list[tuple[str, int]] = []
        for parent in parents:
            min_avail = by_name[parent].spec.min_available or 1
            if scaled:
                # scaled replica: order only within its own gang instance
                if my_sg is not None and parent in my_sg.clique_names:
                    pcsg_fqn = naming.pcsg_name(pcs_name, pcs_replica, my_sg.name)
                    deps.append(
                        (
                            naming.podclique_name(pcsg_fqn, my_sg_replica, parent),
                            min_avail,
                        )
                    )
                continue
            parent_sg = sg_of.get(parent)
            if parent_sg is not None:
                pcsg_fqn = naming.pcsg_name(pcs_name, pcs_replica, parent_sg.name)
                for j in range(parent_sg.min_available or 1):
                    deps.append(
                        (naming.podclique_name(pcsg_fqn, j, parent), min_avail)
                    )
            else:
                deps.append(
                    (
                        naming.podclique_name(pcs_name, pcs_replica, parent),
                        min_avail,
                    )
                )
        return deps

    def _template_name(self, pclq: PodClique) -> str:
        """Clique template name from its label (names may contain hyphens,
        so the FQN cannot be split reliably)."""
        return pclq.metadata.labels.get(constants.LABEL_CLIQUE_TEMPLATE, "")

    def _owner_prefix(self, pclq: PodClique) -> str:
        """'<owner>-<replica>' prefix: strip '-<template>' off the FQN."""
        template = self._template_name(pclq)
        name = pclq.metadata.name
        if template and name.endswith(f"-{template}"):
            return name[: -(len(template) + 1)]
        return name.rsplit("-", 1)[0]

    def _owner_pcs(self, pclq: PodClique) -> PodCliqueSet | None:
        """Read-only peek: callers only read the template (startup deps,
        PCSG sizing) — the per-create-batch full PCS clone was measurable
        at 10^3-clique scale."""
        pcs_name = pclq.metadata.labels.get(constants.LABEL_PART_OF)
        if not pcs_name:
            return None
        return self.store.peek(
            PodCliqueSet.KIND, pclq.metadata.namespace, pcs_name
        )

    def _delete_excess(self, pclq: PodClique, active: list[Pod], count: int) -> None:
        """DeletionSorter: prefer gated, then not-ready, then highest index
        (components/pod syncflow.go:206-228)."""

        def sort_key(p: Pod):
            return (
                0 if p.spec.scheduling_gates else 1,
                0 if not p.status.ready else 1,
                -int(p.metadata.labels.get(constants.LABEL_POD_INDEX, 0)),
            )

        result = run_with_slow_start(
            [
                (
                    pod.metadata.name,
                    lambda name=pod.metadata.name: self.store.delete(
                        Pod.KIND, pclq.metadata.namespace, name
                    ),
                )
                for pod in sorted(active, key=sort_key)[:count]
            ]
        )
        result.raise_if_errors("ERR_DELETE_PODS", "delete")

    def _remove_gates(self, pclq: PodClique) -> None:
        """syncflow.go:242-394. Base-gang pods ungate once referenced in
        their PodGang; scaled-gang pods additionally require the base gang
        to be scheduled. Gang lookups/ref sets are computed once per gang,
        not per pod (a clique's pods share their gang)."""
        ns = pclq.metadata.namespace
        ref_sets: dict[str, set[str] | None] = {}
        base_ok: dict[str, bool] = {}
        for pod in self._owned_pods(pclq):
            if not pod.spec.scheduling_gates:
                continue
            gang_name = pod.metadata.labels.get(constants.LABEL_PODGANG)
            if not gang_name:
                continue
            refs = ref_sets.get(gang_name, False)
            if refs is False:
                gang = self.store.peek(PodGang.KIND, ns, gang_name)
                refs = ref_sets[gang_name] = None if gang is None else {
                    ref.name
                    for group in gang.spec.pod_groups
                    for ref in group.pod_references
                }
            if refs is None or pod.metadata.name not in refs:
                continue  # gang absent / not yet referenced (:261)
            base_name = pod.metadata.labels.get(constants.LABEL_BASE_PODGANG)
            if base_name:
                ok = base_ok.get(base_name)
                if ok is None:
                    base = self.store.peek(PodGang.KIND, ns, base_name)
                    ok = base_ok[base_name] = (
                        base is not None and _is_scheduled(base)
                    )
                if not ok:
                    continue  # scaled gang waits for base (:306-345)
            if self.store.ungate_pod(ns, pod.metadata.name):
                self._mark_own()

    # -- status flow (reconcilestatus.go) ----------------------------------
    def _reconcile_status(self, pclq: PodClique) -> tuple[int, bool]:
        """Reads live state (peeks); the write goes through patch_status —
        the status flow runs on every reconcile for every clique, so the
        full-object get() clone here dominated settle at 10^3-clique
        scale. Returns (active gated-pod count, under-replicated) from
        the same single pod pass, so reconcile's retry-timer decisions
        need no second owned-pods scan. Under-replicated (< spec.replicas
        active pods VISIBLE) must arm the retry: the pods this very
        reconcile created can be hidden by a stale read, and their echoed
        events are suppressed as our own — without the timer the rollup
        wedges below spec forever (found by the node-fault chaos sweep)."""
        fresh = self.store.peek(
            KIND, pclq.metadata.namespace, pclq.metadata.name
        )
        if fresh is None:
            return 0, False
        # single pass over the (small) pod list: this flow runs for every
        # clique on every enqueued round at 10^3-clique scale
        pods = []
        ready = scheduled = gated = healthy = outdated = 0
        template_hash = stable_hash(fresh.spec.pod_spec)
        for p in self._owned_pods(fresh):
            if not is_pod_active(p):
                continue
            pods.append(p)
            st = p.status
            if st.ready:
                ready += 1
            if p.node_name:
                scheduled += 1
            if p.spec.scheduling_gates:
                gated += 1
            if is_pod_healthy(p):
                healthy += 1
            if (
                p.metadata.labels.get(constants.LABEL_POD_TEMPLATE_HASH)
                != template_hash
            ):
                outdated += 1
        # rollout tracking for map_event: while outdated pods exist (or the
        # clique is mid-replacement, below complement), readiness flips
        # must re-run the pod component (pod-at-a-time advancement)
        key = (fresh.metadata.namespace, fresh.metadata.name)
        rolling = len(pods) < fresh.spec.replicas or outdated > 0
        if rolling:
            self._rollout_active.add(key)
        else:
            self._rollout_active.discard(key)
        min_avail = fresh.spec.min_available or fresh.spec.replicas
        now = self.store.clock.now()
        scheduled_enough = scheduled >= min_avail
        # Breach only counts once the gang actually scheduled — an
        # unschedulable fresh workload must not tick toward termination
        # (gangterminate guards on PodCliqueScheduled in the reference).
        breached = scheduled_enough and healthy < min_avail
        # cheap no-op precheck against LIVE status: when the counts,
        # conditions and rollout state already match, skip the
        # patch_status machinery (clone + mutate + compare) entirely —
        # roughly half the status rounds at settle scale are no-ops
        cur = fresh.status
        if (
            not rolling
            and cur.rolling_update_progress is None
            and cur.replicas == len(pods)
            and cur.ready_replicas == ready
            and cur.scheduled_replicas == scheduled
            and cur.schedule_gated_replicas == gated
            and cur.observed_generation == fresh.metadata.generation
            and cur.current_pod_template_hash == template_hash
            and not cur.last_errors
            and _cond_matches(
                cur.conditions, constants.CONDITION_PODCLIQUE_SCHEDULED,
                scheduled_enough,
            )
            and _cond_matches(
                cur.conditions, constants.CONDITION_MIN_AVAILABLE_BREACHED,
                breached,
            )
            and cur.last_operation is not None
            and cur.last_operation.state == "Succeeded"
            and cur.selector
            == f"{constants.LABEL_PODCLIQUE}={fresh.metadata.name}"
        ):
            return gated, len(pods) < fresh.spec.replicas

        def mutate(status):
            status.replicas = len(pods)
            status.ready_replicas = ready
            status.scheduled_replicas = scheduled
            status.schedule_gated_replicas = gated
            status.observed_generation = fresh.metadata.generation
            status.selector = (
                f"{constants.LABEL_PODCLIQUE}={fresh.metadata.name}"
            )
            status.current_pod_template_hash = template_hash
            self._track_rollout(fresh, status, pods)
            set_condition(
                status.conditions,
                constants.CONDITION_PODCLIQUE_SCHEDULED,
                "True" if scheduled_enough else "False",
                reason=(
                    constants.REASON_SUFFICIENT_SCHEDULED_PODS
                    if scheduled_enough
                    else constants.REASON_INSUFFICIENT_SCHEDULED_PODS
                ),
                now=now,
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

        self.store.patch_status(
            KIND, fresh.metadata.namespace, fresh.metadata.name, mutate
        )
        return gated, len(pods) < fresh.spec.replicas

    def _track_rollout(self, pclq: PodClique, status, pods: list[Pod]) -> None:
        """Per-clique rolling-update status parity (podclique.go:104-137):
        updated_replicas counts pods on the current template; while outdated
        pods exist, rolling_update_progress records which pods are done and
        which one the pod-at-a-time rollout (_rolling_replace) targets next,
        and flips completed once the last pod matches."""
        current = status.current_pod_template_hash
        updated = sorted(
            p.metadata.name
            for p in pods
            if p.metadata.labels.get(constants.LABEL_POD_TEMPLATE_HASH) == current
        )
        status.updated_replicas = len(updated)
        outdated = [
            p
            for p in pods
            if p.metadata.labels.get(constants.LABEL_POD_TEMPLATE_HASH) != current
        ]
        if outdated:
            prog = status.rolling_update_progress
            if prog is None or prog.completed:
                prog = status.rolling_update_progress = (
                    PodCliqueRollingUpdateProgress()
                )
            # mirror _rolling_replace's actual decision: not-ready outdated
            # pods are all replaced immediately (report the lowest index);
            # a ready victim (highest index) only while EVERY pod is ready;
            # otherwise the rollout is paused and no victim is in flight
            not_ready = [p for p in outdated if not p.status.ready]
            if not_ready:
                victim = min(not_ready, key=_pod_index)
            elif all(p.status.ready for p in pods):
                victim = max(outdated, key=_pod_index)
            else:
                victim = None  # paused: waiting for a replacement to ready
            prog.updated_pods = updated
            prog.current_pod = victim.metadata.name if victim else None
            prog.completed = False
        else:
            prog = status.rolling_update_progress
            if prog is not None and not prog.completed:
                prog.updated_pods = updated
                prog.current_pod = None
                # the last victim's replacement must exist (and be current)
                # before the rollout counts as complete — mid-replacement the
                # clique is below its replica complement
                prog.completed = len(updated) >= pclq.spec.replicas


def _cond_matches(conditions, cond_type: str, want_true: bool) -> bool:
    cond = get_condition(conditions, cond_type)
    return cond is not None and (cond.status == "True") == want_true


def _pod_index(p: Pod) -> int:
    return int(p.metadata.labels.get(constants.LABEL_POD_INDEX, 0))


def _is_scheduled(gang: PodGang) -> bool:
    from ..api.podgang import PodGangConditionType

    cond = get_condition(
        gang.status.conditions, PodGangConditionType.SCHEDULED.value
    )
    return cond is not None and cond.status == "True"
