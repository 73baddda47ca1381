"""Zero-dependency span tracing for the control plane + chaos flight
recorder.

The counterpart of grove_tpu/observability/tracing.py, copied whole. It
imports nothing of grove_tpu, so the two packages' objects compare field
by field.

The reference leans on controller-runtime's Prometheus endpoint and pprof
for visibility (manager.go:42-44,114-119); neither says WHERE a slow gang
spent its time. This module is the missing decomposition layer:

  Span / Tracer     — parent/child spans threaded through the hot paths
                      (manager reconciles, scheduler pre_round/solve/bind,
                      the engine's collapsed `engine.fused` span — or
                      encode/device/repair children on the split path —
                      kubelet pod lifecycle, node-monitor evict/drain).
                      Every span carries BOTH
                      virtual-clock timestamps (v0/v1 — causality and the
                      GangTimeline sum contract run on the simulated
                      clock) and wall perf_counter times (t0/t1 — a whole
                      settle runs at one virtual instant, so wall time is
                      the axis Perfetto renders usefully).
  NOOP_TRACER       — the off-by-default singleton. A disabled
                      instrumentation site costs one method call returning
                      a shared no-op span; no Span objects are allocated
                      (tests/test_tracing.py pins this), so the 10^5-gang
                      bench numbers cannot regress.
  GangTimeline      — stitches per-gang lifecycles (created -> queued ->
                      solved -> bound -> pods-started -> barrier-released
                      -> running) out of raw spans and feeds the
                      grove_trace_gang_phase_seconds{phase=...}
                      histograms: the north-star bind latency, decomposed.
  FlightRecorder    — bounded ring (O(1) append, fixed memory) of recent
                      spans + reconcile errors + events; the chaos
                      harness dumps it to JSON when a seed wedges
                      (docs/observability.md, postmortem workflow).
  chrome_trace()    — Chrome trace-event JSON (Perfetto /
                      chrome://tracing loadable); the CLI in
                      observability/trace.py converts dumps offline.

Contract note: a finished Span stays mutable until exported — callers may
amend attrs (e.g. the manager stamps `outcome` after the span closed) and
the ring holds the object, not a copy.
"""

from __future__ import annotations

import inspect
import json
import time
from collections import deque
from typing import Any, Iterable, Optional

from .causal import (
    CriticalPathFolder,
    CriticalPathObservatory,
    tokens_of,
)

TRACE_DUMP_FORMAT = "grove-trace/v1"
FLIGHT_DUMP_FORMAT = "grove-flight/v1"

#: the gang lifecycle phases GangTimeline decomposes, in order. Each is
#: the gap between two consecutive virtual-clock checkpoints, so the sum
#: telescopes exactly to (running - created) = bind latency + startup.
GANG_PHASES = ("queued", "solving", "binding", "pod_startup", "barrier_wait")


class Span:
    """One traced operation. v0/v1 are virtual-clock seconds, t0/t1 wall
    seconds since the tracer's epoch. attrs is a plain JSON-able dict."""

    __slots__ = ("name", "span_id", "parent_id", "v0", "v1", "t0", "t1",
                 "attrs", "_tracer")

    def __init__(self, tracer, name: str, span_id: int,
                 parent_id: Optional[int], v0: float, t0: float,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.v0 = v0
        self.v1 = v0
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._enter(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and "error" not in self.attrs:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer._finish(self)
        return False

    @property
    def wall_seconds(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "v0": self.v0,
            "v1": self.v1,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        sp = cls(None, d["name"], d.get("span_id", 0), d.get("parent_id"),
                 d.get("v0", 0.0), d.get("t0", 0.0),
                 dict(d.get("attrs") or {}))
        sp.v1 = d.get("v1", sp.v0)
        sp.t1 = d.get("t1", sp.t0)
        return sp


class _NoopSpan:
    """The shared disabled span: enter/exit/set are no-ops. ONE instance
    serves every disabled call site — the overhead-smoke test asserts no
    allocation happens on the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The disabled tracer. `enabled` gates the few per-object hot sites
    (kubelet pod points, scheduler binds) that would otherwise build an
    attrs dict per pod; everything else just calls span() and gets the
    shared no-op span back."""

    __slots__ = ()
    enabled = False
    mode = "off"
    flight = None
    finished: tuple = ()

    def span(self, name: str, /, **attrs: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def point(self, name: str, /, **attrs: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def record_error(self, controller: str, namespace: str, name: str,
                     message: str, virtual_time: float = 0.0) -> None:
        pass

    def summary(self) -> dict:
        return {"enabled": False}

    def flush_gang_phases(self, metrics) -> dict:
        return {}

    def flush_critical_paths(self, metrics=None) -> dict:
        return {}

    def gang_path(self, key: str, created_at: float | None = None,
                  now: float | None = None) -> Optional[dict]:
        return None


NOOP_TRACER = NoopTracer()


def accepts_kwarg(cls, name: str) -> bool:
    """True when `cls(...)` can take the `name` keyword — named parameter
    or **kwargs. Engine holders (GangScheduler, PlacementService) gate
    optional-capability kwargs (tracer injection, device-state knobs) on
    this so a custom engine class with a strict signature keeps working
    with the capability off instead of dying on an unexpected keyword at
    the first solve."""
    try:
        params = inspect.signature(cls).parameters.values()
    except (TypeError, ValueError):  # uninspectable (C-level): assume yes
        return True
    return any(
        p.kind is inspect.Parameter.VAR_KEYWORD or p.name == name
        for p in params
    )


def accepts_tracer_kwarg(cls) -> bool:
    """accepts_kwarg specialization kept for its existing callers."""
    return accepts_kwarg(cls, "tracer")


class Tracer:
    """Recording tracer bound to a virtual clock. Single-threaded by
    design (the whole control plane is): parent/child causality is a
    stack, re-entrant use (a reconcile driving a nested manager round)
    just nests deeper. Finished spans land in a bounded ring
    (deque maxlen) — fixed memory at any trace length."""

    enabled = True
    mode = "full"

    def __init__(self, clock=None, max_spans: int = 65536, flight=None):
        #: anything with .now() -> float (SimClock); None = wall elapsed
        self.clock = clock
        self.max_spans = max_spans
        #: optional FlightRecorder fed a copy of every finished span
        self.flight = flight
        self.finished: deque[Span] = deque(maxlen=max_spans)
        self._stack: list[Span] = []
        self._next_id = 1
        self._t_base = time.perf_counter()
        self.spans_started = 0
        #: (gang_key, bind_span_id) pairs already flushed to metrics —
        #: flush_gang_phases is idempotent per bind
        self._phases_flushed: set[tuple[str, int]] = set()
        #: fleet critical-path aggregation (observability/causal.py);
        #: persists across flushes so the top-K table accumulates
        self.critical = CriticalPathObservatory()
        #: (gang_key, bind_span_id) pairs already observed into the
        #: observatory — flush_critical_paths is idempotent per bind
        self._paths_flushed: set[tuple[str, int]] = set()

    # -- span lifecycle ----------------------------------------------------
    def _now_v(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        return time.perf_counter() - self._t_base

    def span(self, name: str, /, **attrs: Any) -> Span:
        """Open a span (use as a context manager). Parent is whatever
        span is currently open."""
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        self.spans_started += 1
        return Span(self, name, sid, parent, self._now_v(),
                    time.perf_counter() - self._t_base, attrs)

    def _enter(self, span: Span) -> None:
        self._stack.append(span)

    def _finish(self, span: Span) -> None:
        span.v1 = self._now_v()
        span.t1 = time.perf_counter() - self._t_base
        # pop to the span: tolerates unwinds that skipped exits
        # (ManagerCrash raised through a crash-restart)
        while self._stack:
            if self._stack.pop() is span:
                break
        self.finished.append(span)
        if self.flight is not None:
            self.flight.add_span(span)

    def point(self, name: str, /, **attrs: Any) -> Span:
        """Zero-duration span (an event with causality): parented to the
        open span, finished immediately."""
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        self.spans_started += 1
        sp = Span(self, name, sid, parent, self._now_v(),
                  time.perf_counter() - self._t_base, attrs)
        self.finished.append(sp)
        if self.flight is not None:
            self.flight.add_span(sp)
        return sp

    @property
    def open_depth(self) -> int:
        return len(self._stack)

    # -- flight-recorder feeds --------------------------------------------
    def record_error(self, controller: str, namespace: str, name: str,
                     message: str, virtual_time: float = 0.0) -> None:
        if self.flight is not None:
            self.flight.add_error(controller, namespace, name, message,
                                  virtual_time)

    # -- export ------------------------------------------------------------
    def summary(self) -> dict:
        """The debug_dump()/gRPC-Debug tracing section: bounded-size
        counts, never the spans themselves."""
        by_name: dict[str, int] = {}
        for sp in self.finished:
            by_name[sp.name] = by_name.get(sp.name, 0) + 1
        out = {
            "enabled": True,
            "mode": self.mode,
            "spans_started": self.spans_started,
            "spans_retained": len(self.finished),
            "max_spans": self.max_spans,
            "open_spans": len(self._stack),
            "by_name": dict(sorted(by_name.items())),
        }
        if self.flight is not None:
            out["flight"] = self.flight.summary()
        return out

    def dump(self) -> dict:
        return {
            "format": TRACE_DUMP_FORMAT,
            "spans": [sp.to_dict() for sp in self.finished],
        }

    def chrome_trace(self, label: str = "grove") -> dict:
        return chrome_trace({label: self.finished})

    def write_chrome_trace(self, path: str, label: str = "grove") -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(label), fh)
            fh.write("\n")
        return path

    def flush_gang_phases(self, metrics) -> dict:
        """Reconstruct gang timelines from the retained spans and observe
        every COMPLETE, not-yet-flushed gang into
        grove_trace_gang_phase_seconds{phase=...}. Idempotent per bind
        (repeated debug dumps never double-count). Returns the timeline
        report (see GangTimeline.report)."""
        timeline = GangTimeline(self.finished)
        report = timeline.report()
        # prune before (possibly) extending: a bind span evicted from the
        # ring can never be reconstructed again, so its flush marker is
        # dead weight — dropping it keeps this set bounded by the ring
        # size over any run length (the fixed-memory contract)
        live = {
            (key, tl["bind_span_id"])
            for key, tl in timeline.timelines().items()
        }
        self._phases_flushed &= live
        if metrics is not None:
            hist = metrics.histogram(
                "grove_trace_gang_phase_seconds",
                "virtual seconds per gang lifecycle phase "
                "(created->queued->solved->bound->started->running), "
                "reconstructed from trace spans",
            )
            for key, tl in timeline.timelines().items():
                if not tl["complete"]:
                    continue
                flush_key = (key, tl["bind_span_id"])
                if flush_key in self._phases_flushed:
                    continue
                self._phases_flushed.add(flush_key)
                for phase, dur in tl["phases"].items():
                    hist.observe(dur, phase=phase)
        return report

    def flush_critical_paths(self, metrics=None) -> dict:
        """Reconstruct per-gang critical paths from the retained spans,
        observe every not-yet-flushed one into the fleet observatory (and
        grove_trace_critical_path_seconds{segment} when `metrics` is
        given), and return the observatory report. Idempotent per bind —
        repeated debug dumps never double-count; the flush-marker set is
        pruned against the live ring so it stays bounded."""
        paths: list[dict] = []
        folder = CriticalPathFolder(sink=paths.append)
        folder.fold_all(self.finished)
        live = {(p["gang"], p["bind_span_id"]) for p in paths}
        self._paths_flushed &= live
        for p in paths:
            fk = (p["gang"], p["bind_span_id"])
            if fk in self._paths_flushed:
                continue
            self._paths_flushed.add(fk)
            self.critical.observe(p, metrics)
        return self.critical.report()

    def gang_path(self, key: str, created_at: float | None = None,
                  now: float | None = None) -> Optional[dict]:
        """One gang's reconstructed critical path ("ns/name" key):
        complete if the gang finished inside the retained ring, else the
        partial held/admission/handoff waits so far (the wedged-gang
        postmortem view), else None."""
        found: dict[str, dict] = {}
        folder = CriticalPathFolder(
            sink=lambda p: found.__setitem__(p["gang"], p)
        )
        folder.fold_all(self.finished)
        if key in found:
            return found[key]
        if now is None:
            now = self._now_v()
        return folder.pending_path(key, created_at=created_at, now=now)


class AggregateTracer(Tracer):
    """The always-on low-overhead mode (`tracing.mode: aggregate`): the
    span ring is SKIPPED entirely — every finished span folds straight
    into the bounded critical-path folder and per-segment observatory
    sketches, so memory is O(1) at any run length and production keeps
    the latency observatory on while full-ring tracing stays opt-in.

    Consequences, by design: no span dump / Chrome export (the ring is
    empty), no per-span flight-recorder feed (errors and events still
    record), and flush_gang_phases has no ring to reconstruct from — the
    critical-path report IS the aggregate surface. Finalized paths
    observe into `metrics` immediately at fold time."""

    mode = "aggregate"

    #: the only span names the critical-path folder consumes. Everything
    #: else — notably manager.reconcile, the bulk of a settle's spans —
    #: gets the shared no-op span back: no allocation, no fold, which is
    #: what keeps the always-on mode inside its <5% overhead acceptance
    #: (bench.py --aggregate-overhead). scheduler.solve stays real so it
    #: sits on the live stack while its engine children resolve their
    #: enclosing solve id.
    _FOLD_NAMES = frozenset((
        "engine.fused", "engine.encode", "engine.device", "engine.repair",
        "engine.hierarchical", "engine.fine_solve",
        "scheduler.solve", "scheduler.hold", "scheduler.stream_admit",
        "scheduler.bind", "kubelet.pod_start", "kubelet.pod_ready",
    ))

    def __init__(self, clock=None, metrics=None, flight=None,
                 top_k: int = 10):
        super().__init__(clock=clock, max_spans=1, flight=flight)
        self.finished = deque(maxlen=0)  # fold, never retain
        self.metrics = metrics
        self.critical = CriticalPathObservatory(top_k=top_k)
        self.folder = CriticalPathFolder(sink=self._on_path)

    def span(self, name: str, /, **attrs: Any) -> "Span | _NoopSpan":
        if name not in self._FOLD_NAMES:
            return _NOOP_SPAN
        return super().span(name, **attrs)

    def _on_path(self, path: dict) -> None:
        # finalize happens exactly once per bind (the folder drops the
        # pending entry), so no flush-marker dedup is needed here
        self.critical.observe(path, self.metrics)

    def _finish(self, span: Span) -> None:
        span.v1 = self._now_v()
        span.t1 = time.perf_counter() - self._t_base
        while self._stack:
            if self._stack.pop() is span:
                break
        # ancestry resolves against the LIVE stack: children finish
        # while their scheduler.solve parent is still open
        self.folder.fold(span, stack=self._stack)

    def point(self, name: str, /, **attrs: Any) -> "Span | _NoopSpan":
        if name not in self._FOLD_NAMES:
            return _NOOP_SPAN
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        self.spans_started += 1
        sp = Span(self, name, sid, parent, self._now_v(),
                  time.perf_counter() - self._t_base, attrs)
        self.folder.fold(sp, stack=self._stack)
        return sp

    def flush_gang_phases(self, metrics) -> dict:
        return {"aggregate": True, "paths": self.critical.paths}

    def flush_critical_paths(self, metrics=None) -> dict:
        # observation already happened at fold time
        return self.critical.report()

    def gang_path(self, key: str, created_at: float | None = None,
                  now: float | None = None) -> Optional[dict]:
        if now is None:
            now = self._now_v()
        return self.folder.pending_path(key, created_at=created_at,
                                        now=now)

    def summary(self) -> dict:
        out = super().summary()
        out["paths_folded"] = self.critical.paths
        out["folder"] = self.folder.summary()
        return out


class FlightRecorder:
    """Bounded postmortem ring: recent spans + reconcile errors + events.
    deque(maxlen) gives O(1) append and fixed memory; `appended` keeps
    counting past the wrap so dumps state what was dropped."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)
        self.appended = 0
        self.counts: dict[str, int] = {}

    def _add(self, entry: dict) -> None:
        self._ring.append(entry)
        self.appended += 1
        t = entry["type"]
        self.counts[t] = self.counts.get(t, 0) + 1

    def add_span(self, span: Span) -> None:
        self._add({"type": "span", **span.to_dict()})

    def add_error(self, controller: str, namespace: str, name: str,
                  message: str, virtual_time: float = 0.0) -> None:
        self._add({
            "type": "error",
            "controller": controller,
            "namespace": namespace,
            "name": name,
            "error": message,
            "virtual_time": virtual_time,
        })

    def add_event(self, type_: str, reason: str, involved_kind: str,
                  involved_name: str, namespace: str, message: str,
                  virtual_time: float = 0.0) -> None:
        self._add({
            "type": "event",
            "event_type": type_,
            "reason": reason,
            "involved_kind": involved_kind,
            "involved_name": involved_name,
            "namespace": namespace,
            "message": message,
            "virtual_time": virtual_time,
        })

    @property
    def dropped(self) -> int:
        return max(0, self.appended - len(self._ring))

    def entries(self) -> list[dict]:
        return list(self._ring)

    def summary(self) -> dict:
        return {
            "capacity": self.capacity,
            "retained": len(self._ring),
            "appended": self.appended,
            "dropped": self.dropped,
            "by_type": dict(sorted(self.counts.items())),
        }

    def dump(self, wedged: dict | None = None) -> dict:
        """The postmortem artifact: ring contents + a caller-supplied
        `wedged` section (the chaos harness puts the stuck objects,
        manager errors and fault log there)."""
        return {
            "format": FLIGHT_DUMP_FORMAT,
            "summary": self.summary(),
            "wedged": wedged or {},
            "entries": self.entries(),
        }


class GangTimeline:
    """Reconstruct per-gang lifecycles from raw spans.

    Inputs (emitted by the instrumented control plane):
      scheduler.bind   point, attrs: gang="ns/name", created_at, pods=N
                       — parented (transitively) under scheduler.solve
      scheduler.solve  span per backlog solve round
      scheduler.stream_admit
                       point, attrs: gang="ns/name", queue_wait —
                       emitted at micro-batch consume time when the
                       streaming admission front is on; surfaces as the
                       per-gang `queue_wait` timeline field (a SEPARATE
                       annotation, NOT a GANG_PHASES entry: the phase
                       sum telescopes exactly to running - created, and
                       the stream wait is already inside `queued`)
      kubelet.pod_start / kubelet.pod_ready
                       points, attrs: namespace, gang, pod="ns/name"

    Virtual-clock checkpoints per gang: created, solve_start, solved,
    bound, pods_started (last member pod start), running (last member pod
    ready = barrier released). Checkpoints are monotone-clamped, so the
    phase durations are non-negative and telescope EXACTLY to
    (running - created) = recorded bind latency + startup time — the sum
    contract tests/test_tracing.py pins against
    grove_scheduler_gang_bind_latency_seconds."""

    def __init__(self, spans: Iterable):
        self.spans: list[Span] = [
            sp if isinstance(sp, Span) else Span.from_dict(sp)
            for sp in spans
        ]
        self._by_id = {sp.span_id: sp for sp in self.spans}
        #: memoized timelines(): the span list is snapshotted above, so
        #: the reconstruction can never change — callers (report, the
        #: flush-marker pruning and the metrics flush) share one pass
        #: instead of re-walking the ring per call
        self._timelines: dict[str, dict] | None = None

    def _solve_ancestor(self, span: Span) -> Optional[Span]:
        seen = 0
        cur = span
        while cur.parent_id is not None and seen < 64:
            cur = self._by_id.get(cur.parent_id)
            if cur is None:
                return None
            if cur.name == "scheduler.solve":
                return cur
            seen += 1
        return None

    def timelines(self) -> dict[str, dict]:
        """gang key ("ns/name") -> {checkpoints, phases, complete,
        bind_span_id}. A gang bound multiple times (preempted + rebound)
        keeps its LAST bind; pod points before that bind are ignored."""
        if self._timelines is not None:
            return self._timelines
        binds: dict[str, Span] = {}
        for sp in self.spans:
            if sp.name == "scheduler.bind":
                key = sp.attrs.get("gang")
                if key:
                    prev = binds.get(key)
                    if prev is None or sp.v0 >= prev.v0:
                        binds[key] = sp
        stream_waits: dict[str, float] = {}
        for sp in self.spans:
            if sp.name == "scheduler.stream_admit":
                key = sp.attrs.get("gang")
                if key:
                    # last admit wins, matching the last-bind rule: a
                    # shed-then-readmitted gang reports the wait of the
                    # admission that actually led to its bind
                    stream_waits[key] = float(
                        sp.attrs.get("queue_wait", 0.0)
                    )
        starts: dict[str, dict[str, float]] = {}
        readies: dict[str, dict[str, float]] = {}
        for sp in self.spans:
            if sp.name not in ("kubelet.pod_start", "kubelet.pod_ready"):
                continue
            key = f"{sp.attrs.get('namespace')}/{sp.attrs.get('gang')}"
            pod = sp.attrs.get("pod")
            if not pod:
                continue
            bucket = starts if sp.name == "kubelet.pod_start" else readies
            per = bucket.setdefault(key, {})
            per[pod] = max(per.get(pod, float("-inf")), sp.v0)
        out: dict[str, dict] = {}
        for key, bind in binds.items():
            created = float(bind.attrs.get("created_at", bind.v0))
            pods_expected = int(bind.attrs.get("pods", 0))
            solve = self._solve_ancestor(bind)
            solve_start = solve.v0 if solve is not None else bind.v0
            solved = solve.v1 if solve is not None else bind.v0
            bound = bind.v0
            gang_starts = {
                p: v for p, v in starts.get(key, {}).items() if v >= bound
            }
            gang_readies = {
                p: v for p, v in readies.get(key, {}).items() if v >= bound
            }
            have_all = (
                pods_expected > 0
                and len(gang_starts) >= pods_expected
                and len(gang_readies) >= pods_expected
            )
            pods_started = max(gang_starts.values(), default=bound)
            running = max(gang_readies.values(), default=pods_started)
            # monotone clamp: out-of-order observations (a solve span
            # reused across clock jumps) can never produce a negative
            # phase, and the telescoped sum stays exact
            cp = [created, solve_start, solved, bound, pods_started,
                  running]
            for i in range(1, len(cp)):
                cp[i] = max(cp[i], cp[i - 1])
            phases = {
                name: cp[i + 1] - cp[i]
                for i, name in enumerate(GANG_PHASES)
            }
            out[key] = {
                "bind_span_id": bind.span_id,
                "checkpoints": {
                    "created": cp[0],
                    "solve_start": cp[1],
                    "solved": cp[2],
                    "bound": cp[3],
                    "pods_started": cp[4],
                    "running": cp[5],
                },
                "phases": phases,
                # streaming admission queue wait (None without the
                # stream front): an annotation BESIDE the phases — the
                # GANG_PHASES telescoping-sum contract is untouched
                "queue_wait": stream_waits.get(key),
                "bind_latency": cp[3] - cp[0],
                "startup": cp[5] - cp[3],
                "total": cp[5] - cp[0],
                "pods_expected": pods_expected,
                "pods_started_seen": len(gang_starts),
                "pods_ready_seen": len(gang_readies),
                "complete": have_all,
            }
        self._timelines = out
        return out

    def report(self) -> dict:
        """Aggregate latency decomposition: per-phase totals/max over the
        complete gangs (the bounded summary surfaced in debug dumps)."""
        tls = self.timelines()
        complete = [tl for tl in tls.values() if tl["complete"]]
        phases: dict[str, dict[str, float]] = {}
        for name in GANG_PHASES:
            vals = [tl["phases"][name] for tl in complete]
            phases[name] = {
                "sum": round(sum(vals), 9),
                "max": round(max(vals), 9) if vals else 0.0,
            }
        waits = [
            tl["queue_wait"] for tl in complete
            if tl["queue_wait"] is not None
        ]
        return {
            "gangs": len(tls),
            "complete": len(complete),
            "phase_seconds": phases,
            "bind_latency_sum": round(
                sum(tl["bind_latency"] for tl in complete), 9
            ),
            "startup_sum": round(
                sum(tl["startup"] for tl in complete), 9
            ),
            # streaming admission wait (gangs carrying a stream_admit
            # point; zero-sum with no stream front)
            "queue_wait_sum": round(sum(waits), 9),
            "queue_wait_max": round(max(waits), 9) if waits else 0.0,
        }


# -- Chrome trace-event export ---------------------------------------------
def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def chrome_trace_events(spans: Iterable[Span], pid: int = 1,
                        label: str | None = None,
                        shift: float = 0.0) -> list[dict]:
    """Spans -> Chrome trace-event list. Duration spans become "X"
    (complete) events, zero-duration points become "i" (instant) events;
    ts/dur are wall microseconds (single-threaded execution means stack
    containment holds on one tid). Virtual times ride in args. `shift`
    (seconds) is added to every ts — chrome_trace uses it to put groups
    recorded by different tracers onto one shared time axis.

    Causal edges (observability/causal.py): a span whose attrs carry
    causal_emit becomes a flow START ("s") and causal_link a flow END
    ("f", bp="e"), one event per token, sharing the token as the flow
    `id`. Token ids are process-globally unique, so arrows connect
    producer and consumer even across tracer groups (pids) in a merged
    dump — a multi-tracer, multi-shard trace renders as connected
    arrows in Perfetto."""
    events: list[dict] = []
    if label:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 1,
            "args": {"name": label},
        })
    for sp in spans:
        args = {k: _jsonable(v) for k, v in sp.attrs.items()}
        args["virtual_t0"] = sp.v0
        args["virtual_t1"] = sp.v1
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        ts = round((sp.t0 + shift) * 1e6, 3)
        ev = {
            "name": sp.name,
            "cat": sp.name.split(".", 1)[0],
            "pid": pid,
            "tid": 1,
            "ts": ts,
            "args": args,
        }
        if sp.t1 > sp.t0:
            ev["ph"] = "X"
            ev["dur"] = round((sp.t1 - sp.t0) * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
        for tok in tokens_of(sp.attrs.get("causal_link")):
            events.append({
                "name": "causal", "cat": "causal", "ph": "f", "bp": "e",
                "id": tok, "pid": pid, "tid": 1, "ts": ts,
            })
        for tok in tokens_of(sp.attrs.get("causal_emit")):
            events.append({
                "name": "causal", "cat": "causal", "ph": "s",
                "id": tok, "pid": pid, "tid": 1, "ts": ts,
            })
    return events


def chrome_trace(groups: dict[str, "Iterable[Span] | Tracer"]) -> dict:
    """{label: spans-or-Tracer} -> one Perfetto-loadable JSON object;
    each group renders as its own named process. Deterministic pid
    assignment by label order.

    Span t0/t1 are relative to the PRIVATE epoch of the tracer that
    recorded them, so merging span lists from different tracers would
    stack every group at ts~0 and sequential work would render as
    concurrent. Pass the Tracer objects themselves (bench.py --trace
    does) and each group is shifted by its tracer's epoch delta from
    the earliest one — the merged trace shares one real time axis."""
    resolved: list[tuple[str, Iterable[Span], float | None]] = []
    epochs: list[float] = []
    for label, g in groups.items():
        if isinstance(g, Tracer):
            resolved.append((label, g.finished, g._t_base))
            epochs.append(g._t_base)
        else:
            resolved.append((label, g, None))
    base = min(epochs) if epochs else 0.0
    events: list[dict] = []
    for i, (label, spans, epoch) in enumerate(resolved):
        shift = (epoch - base) if epoch is not None else 0.0
        events.extend(
            chrome_trace_events(spans, pid=i + 1, label=label, shift=shift)
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
