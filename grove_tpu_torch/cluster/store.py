"""In-memory versioned object store — the kube-apiserver of the simulation.

Plays the role the real API server plays for the reference operator:
admission hooks on create/update (the webhook chain,
operator/internal/webhook/register.go:34-63), resourceVersion on every
write, generation bump on spec changes (what the reference's
generation-change predicates key on), finalizer-gated deletion, owner
references, and an append-only event log that the controller runtime drains
(the informer/watch bus).

Deliberately single-threaded: the reconcile loop is driven to quiescence by
the controller manager, which makes every test deterministic — the
reference needs its expectations store (internal/expect/) precisely because
informer caches are stale; the simulation keeps that machinery (the
controllers still read through a snapshot they took at reconcile start) but
the store itself is always consistent.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import itertools
import operator
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .clock import SimClock


class StoreError(Exception):
    pass


class NotFound(StoreError):
    pass


class AlreadyExists(StoreError):
    pass


class Forbidden(StoreError):
    """Raised by the authorization hook (the authorization-webhook analog,
    operator/internal/webhook/admission/pcs/authorization/)."""


@dataclass(slots=True)
class Event:
    """Watch event. seq is a global total order (the 'resource version' of
    the event stream)."""

    seq: int
    type: str          # "Added" | "Modified" | "Deleted"
    kind: str
    namespace: str
    name: str
    obj: Any           # post-write snapshot (pre-delete snapshot for Deleted)
    old: Any = None    # pre-write snapshot for Modified


@dataclass
class Admission:
    """Per-kind admission chain (defaulting then validation webhooks)."""

    default: Optional[Callable[[Any], Any]] = None
    validate: Optional[Callable[[Any], None]] = None
    validate_update: Optional[Callable[[Any, Any], None]] = None


def _key(namespace: str, name: str) -> tuple[str, str]:
    return (namespace, name)


#: C-implemented accessors for the hot paths (scan sort, event bisect)
_SCAN_KEY = operator.attrgetter("metadata.namespace", "metadata.name")
_EVENT_SEQ = operator.attrgetter("seq")


# Per-class cloner registry. Store objects are trees (no aliasing/cycles)
# of dataclasses, dicts, lists and scalars, and the control-plane settle
# loop clones them millions of times (every get/write/event snapshot) —
# generic copy.deepcopy or even a hand-rolled isinstance walk dominates
# wall-clock at 1000-replica scale. Cloners are code-generated per class
# once, with scalar fields short-circuited inline.
_SCALARS = frozenset((str, int, float, bool, type(None)))
_CLONERS: dict[type, Callable[[Any], Any]] = {}


def _clone_dict(o: dict) -> dict:
    return {
        k: v if v.__class__ in _SCALARS else clone(v) for k, v in o.items()
    }


def _clone_list(o: list) -> list:
    return [v if v.__class__ in _SCALARS else clone(v) for v in o]


def _make_cloner(cls: type) -> Callable[[Any], Any]:
    if cls in _SCALARS or (
        isinstance(cls, type) and issubclass(cls, (str, int, float))
    ):
        # covers the (str, Enum) condition/phase types — immutable
        c = lambda o: o  # noqa: E731
    elif cls is dict:
        c = _clone_dict
    elif cls is list:
        c = _clone_list
    elif cls is tuple:
        c = lambda o: tuple(_clone_list(list(o)))  # noqa: E731
    elif dataclasses.is_dataclass(cls):
        frozen = cls.__dataclass_params__.frozen
        lines = ["def _c(o, _new=_new, _cls=_cls, _sc=_sc, _cl=_cl):",
                 "    n = _new(_cls)"]
        for f in dataclasses.fields(cls):
            rhs = f"o.{f.name} if o.{f.name}.__class__ in _sc else _cl(o.{f.name})"
            if frozen:
                lines.append(f"    object.__setattr__(n, {f.name!r}, {rhs})")
            else:
                lines.append(f"    n.{f.name} = {rhs}")
        lines.append("    return n")
        ns = {"_new": object.__new__, "_cls": cls, "_sc": _SCALARS,
              "_cl": clone}
        exec("\n".join(lines), ns)
        c = ns["_c"]
    else:
        c = copy.deepcopy  # ndarray or other exotic payloads
    _CLONERS[cls] = c
    return c


def clone(obj: Any) -> Any:
    """Specialized deep copy for store objects via per-class generated
    cloners (see _make_cloner)."""
    cls = obj.__class__
    c = _CLONERS.get(cls)
    if c is None:
        c = _make_cloner(cls)
    return c(obj)


#: per-class generated shallow-copiers (slots-compatible: the hot
#: dataclasses use slots=True, which have no __dict__ to bulk-update)
_SHALLOWERS: dict[type, Callable[[Any], Any]] = {}


def _make_shallower(cls: type) -> Callable[[Any], Any]:
    if dataclasses.is_dataclass(cls):
        lines = ["def _s(o, _new=_new, _cls=_cls):", "    n = _new(_cls)"]
        for f in dataclasses.fields(cls):
            lines.append(f"    n.{f.name} = o.{f.name}")
        lines.append("    return n")
        ns = {"_new": object.__new__, "_cls": cls}
        exec("\n".join(lines), ns)
        fn = ns["_s"]
    else:
        def fn(o, _cls=cls):
            n = object.__new__(_cls)
            n.__dict__.update(o.__dict__)
            return n
    _SHALLOWERS[cls] = fn
    return fn


def _shallow(obj: Any) -> Any:
    """New instance sharing every field with obj (MVCC version bump:
    the caller replaces the fields that change, e.g. metadata/status)."""
    cls = obj.__class__
    f = _SHALLOWERS.get(cls)
    if f is None:
        f = _make_shallower(cls)
    return f(obj)


# Native hot path: clone/_shallow execute ~200k times per stress-config
# settle (every MVCC write makes one of each; see BASELINE.md), and the
# exec-generated Python versions above were the largest remaining host cost
# (VERDICT r4 #1). The _grove_storecore C extension runs the same recursive
# copy with per-class slot-offset access; unknown classes resolve once
# through _native_resolve, which either registers the slot layout or hands
# the extension the Python fallback — so semantics are identical and the
# pure-Python path remains complete when no toolchain exists
# (GROVE_TPU_NO_NATIVE_STORE=1 forces it, for tests and bisection).
def _native_resolve(cls: type) -> None:
    if (
        dataclasses.is_dataclass(cls)
        and _NATIVE_STORE.register_dataclass(
            cls, tuple(f.name for f in dataclasses.fields(cls))
        )
    ):
        return None
    _NATIVE_STORE.register_python(
        cls, _make_cloner(cls), _make_shallower(cls)
    )
    return None


def _install_native_store() -> bool:
    """Swap clone/_shallow for the C versions when the extension builds.
    Returns True when native is active (introspection + tests)."""
    global clone, _shallow, _NATIVE_STORE
    from ..native.storecore import load_storecore

    mod = load_storecore()
    if mod is None:
        return False
    _NATIVE_STORE = mod
    mod.set_resolve(_native_resolve)
    clone = mod.clone
    _shallow = mod.shallow
    return True


_NATIVE_STORE: Any = None
NATIVE_STORE_ACTIVE = _install_native_store()


def _bump_meta(meta: Any) -> Any:
    """Metadata for a new MVCC version whose labels/annotations/owner refs
    do not change: a SHALLOW ObjectMeta sharing those containers with the
    frozen previous version. Only scalar fields (resource_version,
    generation) may be set on the result; a writer that mutates a shared
    container must replace it with a fresh list/dict first (_touch_meta
    does this for finalizers). Deep-cloning metadata per status write was
    the single largest clone source at 1000-replica settle scale."""
    return _shallow(meta)


def _spec_equal(a: Any, b: Any) -> bool:
    """Generation-relevant equality: .spec when present, otherwise every
    field except metadata/status (e.g. Node.allocatable/unschedulable).
    Dataclass __eq__ compares field tuples recursively — far cheaper than
    materializing asdict() twice per write on the settle hot path."""
    sa = getattr(a, "spec", None)
    if sa is not None:
        return sa == getattr(b, "spec", None)
    for f in dataclasses.fields(a):
        if f.name in ("metadata", "status"):
            continue
        if getattr(a, f.name) != getattr(b, f.name):
            return False
    return True


#: Actor attributed to direct store calls (tests, users at the kubectl
#: boundary). Controllers impersonate the operator identity via the manager.
DEFAULT_ACTOR = "user"

#: The store-internal garbage collector's identity (always authorized, like
#: the apiserver's own GC controller).
GC_ACTOR = "system:garbage-collector"

#: The public entry points whose outermost calls ObjectStore.charge_calls
#: charges to the open span. peek and kind_bucket are dict lookups and
#: stay uncharged.
CHARGED_OPS = (
    "get", "list", "scan", "create", "update", "update_status",
    "patch_status", "bind_pod", "ungate_pod", "delete", "add_finalizer",
    "remove_finalizer", "events_since", "relist", "compact_events",
)


class ObjectStore:
    def __init__(self, clock: SimClock | None = None):
        self.clock = clock or SimClock()
        self._objs: dict[str, dict[tuple[str, str], Any]] = {}
        self._admission: dict[str, Admission] = {}
        self._events: list[Event] = []
        self._compacted_seq = 0  # compaction horizon (see compact_events)
        self._kind_serial: dict[str, int] = {}
        self._seq = itertools.count(1)
        # next uid number (a plain int, not itertools.count: the durable
        # snapshot must capture and restore the counter position exactly —
        # recycling a deleted object's uid after recovery would diverge
        # from a never-crashed store)
        self._uid = 1
        #: write-ahead log (cluster/durability.DurableLog) when attached;
        #: None = the classic in-memory-only store — the hot path pays one
        #: predicted-not-taken branch per commit
        self._wal = None
        self.durability = None
        #: stats of the last recover()/recover_in_place() (None = this
        #: store never recovered from disk)
        self.recovery_stats: dict | None = None
        #: authorize(actor, verb, obj) -> None | raise Forbidden. None =
        #: authorization disabled (the default; see api.config).
        self.authorizer: Optional[Callable[[str, str, Any], None]] = None
        self.actor = DEFAULT_ACTOR
        # Label index: (kind, label_key, label_value) -> {obj key: None}
        # (an ordered set). Label-filtered list/scan walk the smallest
        # matching bucket instead of every object of the kind — the
        # equivalent of client-go's field/label indexers, and the
        # difference between O(pods) and O(match) per controller scan at
        # 1000-gang scale. Buckets hold KEYS, not objects: an MVCC version
        # bump with unchanged labels (status writes, binds — the vast
        # majority) skips index maintenance entirely.
        self._label_idx: dict[tuple[str, str, str], dict[tuple[str, str], None]] = {}

    # -- tracing -----------------------------------------------------------
    def charge_calls(self, tracer) -> None:
        """Charge the wall time of each outermost CHARGED_OPS call to
        `tracer`'s innermost open span, adding to its `store_seconds` and
        `store_calls` attrs; a call made with no span open is recorded as
        a `store.call` span (attr `op`). Calls nested in a charged one
        (list through scan, admission webhooks inside create, the WAL
        append inside _emit) are part of its time and not charged again.
        Installed as instance attributes by Cluster.enable_tracing in
        full mode: a store that is not traced runs the plain methods."""
        stack = tracer._stack
        clock = time.perf_counter
        depth = [0]

        def charged(op, plain):
            def call(*args, **kwargs):
                if depth[0]:
                    return plain(*args, **kwargs)
                depth[0] = 1
                try:
                    if not stack:
                        with tracer.span("store.call", op=op):
                            return plain(*args, **kwargs)
                    attrs = stack[-1].attrs
                    t0 = clock()
                    try:
                        return plain(*args, **kwargs)
                    finally:
                        attrs["store_seconds"] = (
                            attrs.get("store_seconds", 0.0) + clock() - t0)
                        attrs["store_calls"] = attrs.get("store_calls", 0) + 1
                finally:
                    depth[0] = 0

            call.__name__ = op
            call.__wrapped__ = plain
            return call

        cls = type(self)
        for op in CHARGED_OPS:
            setattr(self, op, charged(op, getattr(cls, op).__get__(self)))

    # -- admission ---------------------------------------------------------
    def register_admission(self, kind: str, admission: Admission) -> None:
        self._admission[kind] = admission

    # -- authorization ------------------------------------------------------
    @contextmanager
    def impersonate(self, identity: str):
        """Attribute writes inside the block to `identity` (how the
        controller manager runs reconciles as the operator service
        account)."""
        prev, self.actor = self.actor, identity
        try:
            yield
        finally:
            self.actor = prev

    def _authorize(self, verb: str, obj: Any) -> None:
        if self.authorizer is not None:
            self.authorizer(self.actor, verb, obj)

    def authorize_read(
        self, actor: str, verb: str, resource: str, namespace: str
    ) -> None:
        """RBAC read check for service-account identities (the token the
        reference's startup-barrier watcher authenticates with,
        initc/internal/wait.go:76-90). A `system:serviceaccount:<ns>:<sa>`
        actor needs a RoleBinding in `namespace` to a Role whose rules
        include `<resource>:<verb>`; raises Forbidden otherwise. Non-SA
        actors (operator, tests at the kubectl boundary, GC) are not
        constrained by namespace Roles — matching how the reference's
        operator runs with its own cluster-wide RBAC."""
        prefix = f"system:serviceaccount:{namespace}:"
        if not actor.startswith("system:serviceaccount:"):
            return
        if not actor.startswith(prefix):
            raise Forbidden(
                f"{actor}: cross-namespace access to {namespace} denied"
            )
        sa_name = actor[len(prefix):]
        want = f"{resource}:{verb}"
        if want not in self.read_grants(namespace).get(sa_name, ()):
            raise Forbidden(
                f"{actor} cannot {verb} {resource} in namespace {namespace}: "
                "no RoleBinding grants it"
            )

    def read_grants(self, namespace: str) -> dict[str, set[str]]:
        """service-account name -> union of granted `resource:verb` rules
        in the namespace (via RoleBindings -> Roles). One call resolves
        every SA, so per-tick consumers (the kubelet barrier) stay
        O(#RoleBindings) per namespace instead of re-scanning per SA."""
        out: dict[str, set[str]] = {}
        for rb in self.scan("RoleBinding", namespace=namespace):
            role = self.peek("Role", namespace, rb.role_name)
            if role is not None:
                out.setdefault(rb.service_account_name, set()).update(
                    role.rules
                )
        return out

    # -- label index --------------------------------------------------------
    def _index_add(self, kind: str, key: tuple[str, str], obj: Any) -> None:
        for lk, lv in obj.metadata.labels.items():
            self._label_idx.setdefault((kind, lk, lv), {})[key] = None

    def _index_remove(self, kind: str, key: tuple[str, str], obj: Any) -> None:
        for lk, lv in obj.metadata.labels.items():
            bucket = self._label_idx.get((kind, lk, lv))
            if bucket is not None:
                bucket.pop(key, None)

    def _candidates(self, kind: str, labels: dict[str, str] | None):
        """Objects to filter: the smallest indexed label bucket when a label
        selector is given, else every object of the kind."""
        if labels:
            best = None
            for lk, lv in labels.items():
                bucket = self._label_idx.get((kind, lk, lv))
                if bucket is None:
                    return ()
                if best is None or len(bucket) < len(best):
                    best = bucket
            objs = self._objs.get(kind, {})
            return [objs[k] for k in best]
        return self._objs.get(kind, {}).values()

    # -- event log ---------------------------------------------------------
    def events_since(self, seq: int) -> list[Event]:
        """All events with Event.seq > seq (the watch 'resume' contract).
        Asking for history older than the compaction horizon raises — a
        silent gap would make a consumer miss writes (the apiserver answers
        the same situation with 410 Gone)."""
        if seq < self._compacted_seq:
            raise StoreError(
                f"events before seq {self._compacted_seq} were compacted "
                f"(requested since {seq})"
            )
        # seqs are strictly increasing: binary-search the resume point
        # instead of filtering the whole log (every consumer pays this per
        # drain round; linear scans dominated at 10^5-event settle scale)
        i = bisect.bisect_right(self._events, seq, key=_EVENT_SEQ)
        return self._events[i:]

    def compact_events(self, before_seq: int) -> int:
        """Drop events with seq <= before_seq (long simulations otherwise
        grow the append-only log without bound — the real apiserver keeps
        only a bounded watch window the same way). Callers must pass a seq
        every consumer has already drained past; later events_since() calls
        below the horizon raise (and the caller relists, see relist()).
        Returns the number of events dropped."""
        # clamp: an overshooting horizon must not outrun the actually
        # emitted seqs, or last_seq rewinds and valid future cursors get
        # poisoned
        before_seq = min(before_seq, self.last_seq)
        before = len(self._events)
        self._events = [e for e in self._events if e.seq > before_seq]
        dropped = before - len(self._events)
        if dropped:
            self._compacted_seq = max(self._compacted_seq, before_seq)
            if self._wal is not None:
                # journal the (post-clamp) horizon: replay must reproduce
                # the retained watch window, not just the object table.
                # The WAL itself is never truncated here — its truncation
                # is tied to snapshots (durability.DurableLog._prune)
                self._wal.log_compaction(self, before_seq)
        return dropped

    def relist(self) -> tuple[list[Event], int]:
        """Initial-LIST analog: synthetic Added events for every live
        object (NOT appended to the log) + the seq to resume the watch
        from. A consumer whose cursor fell behind the compaction horizon
        recovers exactly like an informer after 410 Gone: relist, then
        watch from the head."""
        head = self.last_seq
        events = [
            Event(
                seq=head,
                type="Added",
                kind=kind,
                namespace=obj.metadata.namespace,
                name=obj.metadata.name,
                obj=obj,
            )
            for kind, bucket in self._objs.items()
            for obj in bucket.values()
        ]
        return events, head

    @property
    def last_seq(self) -> int:
        return self._events[-1].seq if self._events else self._compacted_seq

    # -- public introspection (consumed by observability.debug) ------------
    def object_counts(self) -> dict[str, int]:
        """Live object count per kind (non-empty kinds only)."""
        return {
            kind: len(bucket)
            for kind, bucket in sorted(self._objs.items())
            if bucket
        }

    @property
    def event_log_length(self) -> int:
        """Events currently retained (post-compaction)."""
        return len(self._events)

    @property
    def compaction_horizon(self) -> int:
        """Seq below which history was compacted (0 = never compacted)."""
        return self._compacted_seq

    @property
    def label_index_size(self) -> int:
        """Number of (kind, label, value) index buckets."""
        return len(self._label_idx)

    def _emit(self, type_: str, obj: Any, old: Any = None) -> None:
        """Append a watch event. The store is MVCC — every write REPLACES
        the stored object with a new version and never mutates old versions
        — so events reference versions directly; no snapshot copies."""
        if self._wal is not None:
            # HA fencing (cluster/replication.py): a deposed leader's
            # append fails here — seq counter, event log and WAL all
            # stay untouched, so the durable history (the only state a
            # deposed process can leak into the world) never extends
            self._wal.check_fence()
        seq = next(self._seq)
        self._kind_serial[obj.KIND] = seq
        event = Event(
            seq=seq,
            type=type_,
            kind=obj.KIND,
            namespace=obj.metadata.namespace,
            name=obj.metadata.name,
            obj=obj,
            old=old,
        )
        self._events.append(event)
        if self._wal is not None:
            # durability: the emitted event IS the committed mutation —
            # one WAL record per write, snapshots cut on cadence inside
            # (cluster/durability.py)
            self._wal.commit(self, event)

    def kind_serial(self, kind: str) -> int:
        """Monotonic change marker: the seq of the last write touching
        this kind (0 = never written). Cheap cache key for derived state
        that only depends on one kind (e.g. the topology encoding on
        Node + ClusterTopology)."""
        return self._kind_serial.get(kind, 0)

    # -- reads -------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Any | None:
        bucket = self._objs.get(kind)
        obj = bucket.get((namespace, name)) if bucket is not None else None
        return clone(obj) if obj is not None else None

    def peek(self, kind: str, namespace: str, name: str) -> Any | None:
        """Read-only, NO-COPY access for hot scan paths (the informer-cache
        read analog). The returned object is live store state: callers MUST
        NOT mutate it — fetch with get() before any write-back."""
        bucket = self._objs.get(kind)
        return bucket.get((namespace, name)) if bucket is not None else None

    def kind_bucket(self, kind: str) -> dict[tuple[str, str], Any]:
        """The LIVE (namespace, name) -> object mapping for a kind: peek()
        without the per-call overhead, for loops doing thousands of
        lookups per reconcile (scheduler phase sweeps, kubelet tick).
        Same contract as peek(): strictly read-only — callers must not
        mutate the dict or the objects. The dict stays live (creates and
        deletes show through)."""
        return self._objs.setdefault(kind, {})

    def scan(
        self,
        kind: str,
        namespace: str | None = None,
        labels: dict[str, str] | None = None,
        predicate: Callable[[Any], bool] | None = None,
    ) -> list[Any]:
        """list() without the deepcopy: live references, same filtering and
        deterministic order. Read-only — at control-plane scale the
        defensive copies in list() dominate settle wall-clock, so every
        read-only scan goes through here."""
        out = []
        # a single-label selector needs no re-check: the chosen index
        # bucket IS that label's membership (multi-label selectors verify
        # the labels the bucket doesn't guarantee)
        recheck = labels if labels and len(labels) > 1 else None
        for obj in self._candidates(kind, labels):
            if namespace is not None and obj.metadata.namespace != namespace:
                continue
            if recheck is not None and any(
                obj.metadata.labels.get(k) != v for k, v in recheck.items()
            ):
                continue
            if predicate is not None and not predicate(obj):
                continue
            out.append(obj)
        if len(out) > 1:
            out.sort(key=_SCAN_KEY)
        return out

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        labels: dict[str, str] | None = None,
        predicate: Callable[[Any], bool] | None = None,
    ) -> list[Any]:
        return [clone(o) for o in self.scan(kind, namespace, labels, predicate)]

    def list_owned(self, kind: str, owner_uid: str) -> list[Any]:
        return self.list(
            kind,
            predicate=lambda o: any(
                ref.uid == owner_uid for ref in o.metadata.owner_references
            ),
        )

    # -- writes ------------------------------------------------------------
    def create(self, obj: Any, owned: bool = False) -> Any:
        """owned=True: the caller hands the object over (it was built fresh
        for this call and is never touched again) — the store skips both
        defensive clones and returns the STORED object, which the caller
        must treat as read-only. This is the controllers' create path: at
        10^4-pod settle scale the in+out clones of create() were a top
        clone source."""
        kind = obj.KIND
        self._authorize("create", obj)
        adm = self._admission.get(kind)
        if not owned:
            obj = clone(obj)
        if adm and adm.default:
            adm.default(obj)
        if adm and adm.validate:
            adm.validate(obj)
        key = _key(obj.metadata.namespace, obj.metadata.name)
        bucket = self._objs.setdefault(kind, {})
        if key in bucket:
            raise AlreadyExists(f"{kind} {key} already exists")
        meta = obj.metadata
        meta.uid = f"uid-{self._uid}"
        self._uid += 1
        meta.generation = 1
        meta.resource_version = next(self._seq)
        meta.creation_timestamp = self.clock.now()
        bucket[key] = obj
        self._index_add(kind, key, obj)
        self._emit("Added", obj)
        return obj if owned else clone(obj)

    def update(self, obj: Any) -> Any:
        """Spec/metadata update: bumps generation when the spec changed,
        runs the update-validation webhook against the stored object."""
        return self._write(obj, is_status=False)

    def update_status(self, obj: Any) -> None:
        """Status subresource update: never bumps generation, skips
        admission (mirrors k8s status subresource semantics the reference's
        fake client is configured with, test/utils/setup.go:34-47).
        Returns None — re-read with get() if the stored result is needed."""
        self._write(obj, is_status=True)

    def patch_status(self, kind: str, namespace: str, name: str,
                     mutate: Callable[[Any], None]) -> bool:
        """Status fast path for hot loops: clone ONLY the status, apply
        `mutate` to it, and write back IF it changed. Avoids the full-object
        get()-clone that dominated control-plane settle at 1000-replica
        scale. Returns True when a write happened."""
        key = _key(namespace, name)
        bucket = self._objs.setdefault(kind, {})
        current = bucket.get(key)
        if current is None:
            return False
        status = clone(current.status)
        mutate(status)
        if status == current.status:
            return False
        new = _shallow(current)
        new.status = status
        new.metadata = _bump_meta(current.metadata)
        self._swap(kind, key, current, new)
        return True

    def _swap(self, kind: str, key: tuple[str, str], current: Any,
              new: Any) -> None:
        """Install a new version (MVCC): bump rv, reindex if the labels
        changed (the index maps to keys, so unchanged labels — every
        status write and bind — skip it), emit. `new` must carry its own
        metadata instance (old versions stay frozen)."""
        new.metadata.resource_version = next(self._seq)
        bucket = self._objs[kind]
        old_labels = current.metadata.labels
        new_labels = new.metadata.labels
        if new_labels is not old_labels and new_labels != old_labels:
            self._index_remove(kind, key, current)
            bucket[key] = new
            self._index_add(kind, key, new)
        else:
            bucket[key] = new
        self._emit("Modified", new, old=current)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> bool:
        """Pod binding fast path (the Binding-subresource analog): set
        node_name on an unbound pod without the full update() clone +
        admission machinery. Returns False when the pod is gone or already
        bound.

        Admission exemption (documented contract, advisor r3): like the
        k8s pods/binding and pods/status SUBRESOURCES, this path and
        ungate_pod bypass any registered update-admission webhook for the
        Pod kind — a Pod admission that must see binds/gate-drops has to
        hook the subresource explicitly (not modeled here), exactly as in
        Kubernetes where a pods webhook does not fire for pods/binding."""
        key = _key(namespace, name)
        current = self._objs.get("Pod", {}).get(key)
        if current is None or current.node_name:
            return False
        self._authorize("update", current)
        new = _shallow(current)
        new.node_name = node_name
        new.metadata = _bump_meta(current.metadata)
        self._swap("Pod", key, current, new)
        return True

    def ungate_pod(self, namespace: str, name: str) -> bool:
        """Scheduling-gate removal fast path: drop all gates from a pod
        without the full update() machinery. A gate drop IS a spec change
        (generation bumps, like k8s). Returns False when the pod is gone or
        already ungated."""
        key = _key(namespace, name)
        current = self._objs.get("Pod", {}).get(key)
        if current is None or not current.spec.scheduling_gates:
            return False
        self._authorize("update", current)
        new = _shallow(current)
        new.metadata = _bump_meta(current.metadata)
        new.metadata.generation += 1
        new.spec = _shallow(current.spec)
        new.spec.scheduling_gates = []
        self._swap("Pod", key, current, new)
        return True

    def _write(self, obj: Any, is_status: bool) -> Any:
        kind = obj.KIND
        key = _key(obj.metadata.namespace, obj.metadata.name)
        bucket = self._objs.setdefault(kind, {})
        current = bucket.get(key)
        if current is None:
            raise NotFound(f"{kind} {key} not found")
        if is_status:
            # status subresource writes stay unguarded (kubelet heartbeats,
            # condition updates) — the protection covers spec/metadata.
            # Only the status (+ nothing else) moves; the rest of the new
            # version shares structure with the frozen previous version.
            new = _shallow(current)
            new.status = clone(obj.status)
            new.metadata = _bump_meta(current.metadata)
            self._swap(kind, key, current, new)
            return None
        self._authorize("update", current)
        adm = self._admission.get(kind)
        if adm and adm.validate_update:
            adm.validate_update(current, obj)
        new = clone(obj)
        spec_changed = not _spec_equal(current, new)
        # uid/creation are immutable; carry them over
        new.metadata.uid = current.metadata.uid
        new.metadata.creation_timestamp = current.metadata.creation_timestamp
        new.metadata.generation = current.metadata.generation + (
            1 if spec_changed else 0
        )
        if hasattr(current, "status"):
            # spec writes don't touch status; stored versions never mutate
            # their status in place, so sharing it across versions is safe
            new.status = current.status
        self._swap(kind, key, current, new)
        return clone(new)

    def _touch_meta(self, kind: str, key: tuple[str, str], current: Any,
                    mutate: Callable[[Any], None]) -> Any:
        """Metadata-only version bump (finalizers, deletion stamp). The
        finalizer list is replaced with a fresh copy before `mutate` runs
        so in-place append/remove never reaches the frozen prior version
        (the other metadata containers stay shared — see _bump_meta)."""
        new = _shallow(current)
        new.metadata = _bump_meta(current.metadata)
        new.metadata.finalizers = list(current.metadata.finalizers)
        mutate(new.metadata)
        self._swap(kind, key, current, new)
        return new

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Finalizer-aware delete: with finalizers present only stamps
        deletionTimestamp (Modified event); the object is removed once its
        finalizer list is emptied via update()."""
        key = _key(namespace, name)
        bucket = self._objs.get(kind, {})
        current = bucket.get(key)
        if current is None:
            raise NotFound(f"{kind} {key} not found")
        self._authorize("delete", current)
        if current.metadata.finalizers:
            if current.metadata.deletion_timestamp is None:
                self._touch_meta(
                    kind, key, current,
                    lambda m: setattr(
                        m, "deletion_timestamp", self.clock.now()
                    ),
                )
            return
        del bucket[key]
        self._index_remove(kind, key, current)
        self._emit("Deleted", current)

    def remove_finalizer(self, kind: str, namespace: str, name: str,
                         finalizer: str) -> None:
        """Drop a finalizer; completes deletion if one is pending."""
        key = _key(namespace, name)
        current = self._objs.get(kind, {}).get(key)
        if current is None:
            return
        self._authorize("update", current)
        if finalizer in current.metadata.finalizers:
            current = self._touch_meta(
                kind, key, current,
                lambda m: m.finalizers.remove(finalizer),
            )
        if (
            current.metadata.deletion_timestamp is not None
            and not current.metadata.finalizers
        ):
            del self._objs[kind][key]
            self._index_remove(kind, key, current)
            self._emit("Deleted", current)

    def add_finalizer(self, kind: str, namespace: str, name: str,
                      finalizer: str) -> None:
        current = self._objs.get(kind, {}).get(_key(namespace, name))
        if current is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        self._authorize("update", current)
        if finalizer not in current.metadata.finalizers:
            self._touch_meta(
                current.KIND, _key(namespace, name), current,
                lambda m: m.finalizers.append(finalizer),
            )

    # -- durability ---------------------------------------------------------
    def attach_durability(self, log) -> None:
        """Attach a cluster.durability.DurableLog: every committed
        mutation from here on is write-ahead logged and snapshotted on
        cadence. Attach BEFORE the first write so the WAL covers the
        whole history (Cluster does this right after store construction);
        a recovery then needs no out-of-band bootstrap state."""
        self._wal = log
        self.durability = log

    @classmethod
    def recover(cls, wal_dir: str, clock: SimClock | None = None) -> "ObjectStore":
        """Cold-start recovery: rebuild a store from the durable state at
        `wal_dir` — newest valid snapshot (checksum-verified, falling
        back to older retained ones on corruption) + WAL replay in seq
        order, torn-tail tolerant. The result is bit-identical to the
        crashed store up to the last durable record: objects, retained
        event log, compaction horizon, kind serials, and the seq/uid
        counters all resume exactly. Recovery stats land on
        `recovery_stats`. The returned store has NO DurableLog attached
        (and no admission/authorizer wiring) — callers re-wire those, or
        use Harness.cold_restart which does."""
        from .durability import load_durable_state

        store = cls(clock=clock)
        store.recovery_stats = load_durable_state(wal_dir, store)
        return store

    def adopt_state(self, other: "ObjectStore", stats: dict | None = None
                    ) -> None:
        """Replace THIS store's state with another store's — the standby
        PROMOTION analog of recover_in_place: every piece of runtime
        wiring (admission chains, authorizer, flight recorder, attached
        DurableLog, clock identity) stays, while objects, event log,
        indexes and counters become the donor's. The donor is consumed —
        its containers are adopted by reference, never copied — and must
        not be used afterwards. The live clock only moves FORWARD (the
        donor's applied stamps are at or behind the leader's clock)."""
        self._objs = {k: b for k, b in other._objs.items() if b}
        self._events = list(other._events)
        self._label_idx = {}
        for kind, bucket in self._objs.items():
            for key, obj in bucket.items():
                self._index_add(kind, key, obj)
        self._kind_serial = dict(other._kind_serial)
        self._compacted_seq = other._compacted_seq
        self._uid = other._uid
        last = (
            self._events[-1].seq if self._events else self._compacted_seq
        )
        self._seq = itertools.count(last + 1)
        if hasattr(self.clock, "_now"):
            self.clock._now = max(self.clock._now, other.clock.now())
        self.recovery_stats = stats or {"outcome": "promoted"}

    def recover_in_place(self, wal_dir: str) -> dict:
        """Replace THIS store's state with the recovered image, keeping
        every piece of runtime wiring (admission chains, authorizer,
        actor, flight recorder, attached DurableLog, clock) — how a
        process-crash fault recovers mid-run without re-plumbing every
        store reference (kubelet, cluster, chaos proxy). Returns the
        recovery stats."""
        from .durability import load_durable_state

        self._objs = {}
        self._events = []
        self._label_idx = {}
        self._kind_serial = {}
        self._compacted_seq = 0
        self._seq = itertools.count(1)
        self._uid = 1
        self.recovery_stats = load_durable_state(wal_dir, self)
        return self.recovery_stats

    # -- garbage collection ------------------------------------------------
    def collect_orphans(self) -> int:
        """Kubernetes GC equivalent: delete objects whose controller owner
        no longer exists. Returns number of deletions triggered."""
        deleted = 0
        live_uids = {
            o.metadata.uid
            for bucket in self._objs.values()
            for o in bucket.values()
        }
        with self.impersonate(GC_ACTOR):
            for kind, bucket in list(self._objs.items()):
                for obj in list(bucket.values()):
                    refs = obj.metadata.owner_references
                    if refs and all(r.uid not in live_uids for r in refs):
                        self.delete(
                            kind, obj.metadata.namespace, obj.metadata.name
                        )
                        deleted += 1
        return deleted
