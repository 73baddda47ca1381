"""Causal critical-path extraction across the control plane's hops.

The counterpart of grove_tpu/observability/causal.py, copied whole. It
imports nothing of grove_tpu, so the two packages' objects compare field
by field.

The reference delegates placement to an external scheduler and never has
to answer "where did this gang's latency go" across layers. Our
reproduction grew six latency-bearing hops the reference lacks —
streaming admission window, tenancy/quota bands, shard handoff, coarse
prune + per-domain fine solve, the Pallas device tier, and federation
routing — so a p99 bind regression needs attribution, not just a total.
This module is the substrate:

  next_token()      — process-globally unique monotonic causal token ids.
                      Token ids are shared across every tracer in the
                      process, which is exactly what lets Perfetto flow
                      arrows cross tracer groups (pids) in a merged dump.
  CausalLedger      — bounded key -> latest-token map riding the
                      ObjectStore (`store.causal`): every layer that holds
                      the store (controllers, shard workers, kubelet,
                      federation members via their cluster) can hand a
                      token from the previous hop to the next one without
                      new constructor plumbing. emit/follow/handoff only;
                      no store writes, no RNG — chaos seeds stay
                      bit-identical with the ledger on.
  SEGMENTS          — the ten-hop critical-path decomposition of one
                      gang's created -> running life. Virtual-clock
                      segment durations telescope EXACTLY to
                      (running - created); wall-clock durations for the
                      solve-interior segments ride alongside (they are
                      the axis a device A/B regression moves on).
  CriticalPathFolder— folds finished spans (batch over a span ring, or
                      incrementally as spans finish in aggregate mode)
                      into per-gang paths with bounded state.
  CriticalPathObservatory
                      — fleet aggregation: per-segment {count,sum,max},
                      the grove_trace_critical_path_seconds{segment}
                      histogram, and a bounded top-K slowest-gangs table
                      with each gang's named dominating segment.

Span attribute convention (no Span schema change — to_dict/from_dict and
the flight recorder's attrs aliasing keep working untouched):
  causal_emit: int | [int]   this span produced these token(s)
  causal_link: int | [int]   this span consumed these token(s)
The Chrome exporter turns emit into "s" (flow start) and link into "f"
(flow end) events sharing the token as the flow id.
"""

from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from typing import Callable, Iterable, Optional

#: ordered critical-path segments of one gang's created -> running life.
#: held        Unschedulable stamps -> the release that led to the bind
#: admission   waiting for the streaming front's micro-batch consume
#: handoff     admitted/created -> the owning worker's solve round opens
#:             (shard-handoff + backlog queueing delay)
#: coarse_prune / encode / device / repair
#:             the solve interior, split over the solve's virtual window
#:             proportionally to measured wall time per sub-phase
#: bind        solve-round residual (stamping, store writes)
#: pod_startup bind -> last member pod started
#: barrier_wait last start -> last member pod ready (barrier release)
SEGMENTS = (
    "held", "admission", "handoff", "coarse_prune", "encode",
    "device", "repair", "bind", "pod_startup", "barrier_wait",
)

#: the solve-interior segments distributed by wall-time weight
INTERIOR_SEGMENTS = ("coarse_prune", "encode", "device", "repair", "bind")

_token_counter = itertools.count(1)


def next_token() -> int:
    """Next process-globally unique causal token id. Monotonic within a
    process; uniqueness across tracers is what makes flow arrows connect
    across tracer groups in a merged Chrome dump."""
    return next(_token_counter)


def tokens_of(value) -> tuple:
    """Normalize a causal_emit/causal_link attr to a tuple of ints."""
    if value is None:
        return ()
    if isinstance(value, (list, tuple)):
        return tuple(int(t) for t in value if t is not None)
    return (int(value),)


class CausalLedger:
    """Bounded key -> latest causal token map. Keys are small tuples like
    ("gang", ns, name) / ("pcs", ns, name) / ("shard", idx). FIFO-bounded:
    at `capacity` tracked keys the oldest-touched is dropped — a dropped
    key just means the next hop emits without a link (a broken arrow, not
    an error)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._tokens: OrderedDict = OrderedDict()
        self.emitted = 0

    def emit(self, key) -> int:
        """Mint a fresh token as the latest for `key`."""
        tok = next_token()
        self.emitted += 1
        self._tokens[key] = tok
        self._tokens.move_to_end(key)
        while len(self._tokens) > self.capacity:
            self._tokens.popitem(last=False)
        return tok

    def follow(self, key) -> Optional[int]:
        """Latest token for `key`, or None when never emitted/evicted."""
        return self._tokens.get(key)

    def handoff(self, key) -> tuple[Optional[int], int]:
        """(previous token or None, freshly emitted token): the standard
        hop pattern — link the old, emit the new."""
        prev = self._tokens.get(key)
        return prev, self.emit(key)

    def summary(self) -> dict:
        return {
            "capacity": self.capacity,
            "tracked": len(self._tokens),
            "emitted": self.emitted,
        }


class _SpanView:
    """Duck-typed span shim for dict inputs (dumped spans) so this module
    never imports tracing (tracing imports causal)."""

    __slots__ = ("name", "span_id", "parent_id", "v0", "v1", "t0", "t1",
                 "attrs")

    def __init__(self, d: dict):
        self.name = d.get("name", "")
        self.span_id = d.get("span_id", 0)
        self.parent_id = d.get("parent_id")
        self.v0 = d.get("v0", 0.0)
        self.v1 = d.get("v1", self.v0)
        self.t0 = d.get("t0", 0.0)
        self.t1 = d.get("t1", self.t0)
        self.attrs = d.get("attrs") or {}


class CriticalPathFolder:
    """Fold finished spans into per-gang critical paths.

    Two feeding modes share one implementation:
      * batch — fold_all(spans) over a retained ring (full tracing mode);
        solve ancestry resolves by walking parent_id through the ring.
      * incremental — fold(span, stack=...) as each span finishes
        (aggregate mode); children finish while their scheduler.solve
        parent is still OPEN, so ancestry resolves against the tracer's
        live stack and nothing is ever retained beyond the bounded
        pending maps below.

    All state is bounded: pending gangs / hold / admit marks are
    FIFO-capped OrderedDicts, per-solve wall info is capped, and the
    per-gang pod-name sets are bounded by gang size and freed at
    finalize — O(1) memory at any run length (the aggregate-mode
    contract)."""

    _ENGINE_WALL = {
        "engine.encode": "encode",
        "engine.device": "device",
        "engine.repair": "repair",
    }

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 max_gangs: int = 4096, max_marks: int = 8192,
                 max_solves: int = 512):
        #: called with each finalized path dict
        self.sink = sink
        self.max_gangs = max_gangs
        self.max_marks = max_marks
        self.max_solves = max_solves
        self._by_id: dict = {}
        #: gang key -> (last hold v0, structured code)
        self._holds: OrderedDict = OrderedDict()
        #: gang key -> (stream_admit v0, queue_wait)
        self._admits: OrderedDict = OrderedDict()
        #: scheduler.solve span_id -> wall-decomposition info
        self._solves: OrderedDict = OrderedDict()
        #: gang key -> pending entry (bound, waiting on pod points)
        self._gangs: OrderedDict = OrderedDict()
        self.finalized = 0
        self.dropped = 0

    # -- feeding -----------------------------------------------------------
    def fold_all(self, spans: Iterable) -> None:
        """Batch mode: fold a whole span ring (ring order IS finish
        order, so children fold before their parents finalize — the same
        order the incremental path sees)."""
        resolved = [
            sp if hasattr(sp, "span_id") else _SpanView(sp) for sp in spans
        ]
        self._by_id = {sp.span_id: sp for sp in resolved}
        for sp in resolved:
            self.fold(sp)
        self._by_id = {}

    def _solve_of(self, span, stack) -> Optional[int]:
        if stack is not None:
            for sp in reversed(stack):
                if sp.name == "scheduler.solve":
                    return sp.span_id
            return None
        seen = 0
        cur = span
        while cur.parent_id is not None and seen < 64:
            cur = self._by_id.get(cur.parent_id)
            if cur is None:
                return None
            if cur.name == "scheduler.solve":
                return cur.span_id
            seen += 1
        return None

    def _solve_info(self, sid: int) -> dict:
        info = self._solves.get(sid)
        if info is None:
            info = {"v0": None, "v1": None, "wall": 0.0, "hier": 0.0,
                    "fine": 0.0, "encode": 0.0, "device": 0.0,
                    "repair": 0.0}
            self._solves[sid] = info
            while len(self._solves) > self.max_solves:
                self._solves.popitem(last=False)
        return info

    @staticmethod
    def _evict(od: OrderedDict, cap: int) -> int:
        dropped = 0
        while len(od) > cap:
            od.popitem(last=False)
            dropped += 1
        return dropped

    def fold(self, span, stack=None) -> None:
        """Fold ONE finished span. `stack` is the tracer's live open-span
        stack in incremental mode (None in batch mode)."""
        name = span.name
        attrs = span.attrs
        if name.startswith("engine."):
            sid = self._solve_of(span, stack)
            if sid is None:
                return  # pre_round dispatch work: billed at adoption
            info = self._solve_info(sid)
            if name == "engine.fused":
                info["encode"] += float(attrs.get("encode_seconds", 0.0))
                info["device"] += float(attrs.get("device_seconds", 0.0))
                info["repair"] += float(attrs.get("repair_seconds", 0.0))
            elif name in self._ENGINE_WALL:
                info[self._ENGINE_WALL[name]] += span.t1 - span.t0
            elif name == "engine.hierarchical":
                info["hier"] += span.t1 - span.t0
            elif name == "engine.fine_solve":
                enc = float(attrs.get("encode_seconds", 0.0))
                dev = float(attrs.get("device_seconds", 0.0))
                rep = float(attrs.get("repair_seconds", 0.0))
                info["encode"] += enc
                info["device"] += dev
                info["repair"] += rep
                info["fine"] += enc + dev + rep
            return
        if name == "scheduler.solve":
            info = self._solve_info(span.span_id)
            info["v0"] = span.v0
            info["v1"] = span.v1
            info["wall"] = span.t1 - span.t0
            return
        if name == "scheduler.hold":
            key = attrs.get("gang")
            if key:
                self._holds[key] = (span.v0, attrs.get("code"))
                self._holds.move_to_end(key)
                self.dropped += self._evict(self._holds, self.max_marks)
            return
        if name == "scheduler.stream_admit":
            key = attrs.get("gang")
            if key:
                self._admits[key] = (
                    span.v0, float(attrs.get("queue_wait", 0.0))
                )
                self._admits.move_to_end(key)
                self.dropped += self._evict(self._admits, self.max_marks)
            return
        if name == "scheduler.bind":
            key = attrs.get("gang")
            if not key:
                return
            hold = self._holds.pop(key, None)
            admit = self._admits.pop(key, None)
            entry = {
                "bind_span_id": span.span_id,
                "created": float(attrs.get("created_at", span.v0)),
                "bound": span.v0,
                "pods": int(attrs.get("pods", 0)),
                "solve_id": self._solve_of(span, stack),
                "held_at": hold[0] if hold else None,
                "held_code": hold[1] if hold else None,
                "admitted": admit[0] if admit else None,
                "queue_wait": admit[1] if admit else None,
                "started": set(),
                "ready": set(),
                "last_start": None,
                "last_ready": None,
            }
            # last-bind-wins: a preempted + rebound gang restarts its
            # pending entry (pod points before the new bind are ignored
            # by the v0 >= bound filter below)
            self._gangs[key] = entry
            self._gangs.move_to_end(key)
            self.dropped += self._evict(self._gangs, self.max_gangs)
            if entry["pods"] <= 0:
                del self._gangs[key]
                self._finalize(key, entry)
            return
        if name in ("kubelet.pod_start", "kubelet.pod_ready"):
            key = f"{attrs.get('namespace')}/{attrs.get('gang')}"
            entry = self._gangs.get(key)
            pod = attrs.get("pod")
            if entry is None or not pod or span.v0 < entry["bound"]:
                return
            bucket = (
                entry["started"] if name == "kubelet.pod_start"
                else entry["ready"]
            )
            if pod in bucket:
                return
            bucket.add(pod)
            which = (
                "last_start" if name == "kubelet.pod_start" else "last_ready"
            )
            prev = entry[which]
            entry[which] = span.v0 if prev is None else max(prev, span.v0)
            if (
                name == "kubelet.pod_ready"
                and len(entry["ready"]) >= entry["pods"]
                and len(entry["started"]) >= entry["pods"]
            ):
                del self._gangs[key]
                self._finalize(key, entry)

    # -- path construction -------------------------------------------------
    def _finalize(self, key: str, entry: dict) -> None:
        path = self._build_path(key, entry, complete=True)
        self.finalized += 1
        if self.sink is not None:
            self.sink(path)

    def _build_path(self, key: str, entry: dict, complete: bool,
                    now: Optional[float] = None) -> dict:
        info = (
            self._solves.get(entry["solve_id"])
            if entry["solve_id"] is not None else None
        )
        created = entry["created"]
        release = entry["held_at"] if entry["held_at"] is not None \
            else created
        admitted = entry["admitted"] if entry["admitted"] is not None \
            else release
        solve_v0 = (
            info["v0"] if info is not None and info["v0"] is not None
            else entry["bound"]
        )
        bound = entry["bound"]
        started = entry["last_start"] if entry["last_start"] is not None \
            else bound
        running = entry["last_ready"] if entry["last_ready"] is not None \
            else started
        if not complete and now is not None:
            # open-ended tail: the gang is bound but its pods haven't all
            # released the barrier yet — bill the wait so far
            if entry["last_ready"] is None:
                running = max(running, now)
        # solve-interior wall weights: coarse prune is the hierarchical
        # wall net of the per-domain fine solves; bind is the solve-round
        # residual (stamping + store writes) net of all engine work
        if info is not None:
            coarse_w = max(info["hier"] - info["fine"], 0.0)
            encode_w = info["encode"]
            device_w = info["device"]
            repair_w = info["repair"]
            bind_w = max(
                info["wall"] - coarse_w - encode_w - device_w - repair_w,
                0.0,
            )
        else:
            coarse_w = encode_w = device_w = repair_w = bind_w = 0.0
        weights = (coarse_w, encode_w, device_w, repair_w, bind_w)
        wsum = sum(weights)
        if wsum <= 0.0:
            weights = (0.0, 0.0, 0.0, 0.0, 1.0)
            wsum = 1.0
        # boundary list: 11 monotone virtual-clock boundaries -> 10
        # segment durations that telescope to (running - created). The
        # interior boundaries map the wall-weight CDF onto the
        # [solve_v0, bound] virtual window, with the last pinned to
        # `bound` so the telescoping is exact by construction.
        outer = [created, release, admitted, solve_v0, bound, started,
                 running]
        for i in range(1, len(outer)):
            outer[i] = max(outer[i], outer[i - 1])
        b_solve, b_bound = outer[3], outer[4]
        window = b_bound - b_solve
        bounds = outer[:4]
        cum = 0.0
        for w in weights[:-1]:
            cum += w
            bounds.append(b_solve + window * (cum / wsum))
        bounds.extend(outer[4:])
        for i in range(1, len(bounds)):
            bounds[i] = max(bounds[i], bounds[i - 1])
        segments = {
            name: bounds[i + 1] - bounds[i]
            for i, name in enumerate(SEGMENTS)
        }
        wall = {
            "coarse_prune": coarse_w,
            "encode": encode_w,
            "device": device_w,
            "repair": repair_w,
            "bind": bind_w,
            "solve": info["wall"] if info is not None else 0.0,
        }
        return {
            "gang": key,
            "bind_span_id": entry["bind_span_id"],
            "segments": segments,
            "wall": wall,
            "checkpoints": {
                "created": outer[0],
                "released": outer[1],
                "admitted": outer[2],
                "solve_start": outer[3],
                "bound": outer[4],
                "pods_started": outer[5],
                "running": outer[6],
            },
            "total": bounds[-1] - bounds[0],
            "bind_latency": outer[4] - outer[0],
            "queue_wait": entry["queue_wait"],
            "held_reason": entry["held_code"],
            "dominant": dominant_segment(segments, wall),
            "complete": complete,
        }

    def pending_path(self, key: str, created_at: Optional[float] = None,
                     now: float = 0.0) -> Optional[dict]:
        """Reconstructed PARTIAL path for a gang that never finished —
        the wedged-gang postmortem view. Uses whatever marks exist: a
        bound-but-not-ready entry gets its full prefix with an
        open-ended startup tail; an unbound gang gets its held /
        admission / handoff waits so far. Returns None when nothing at
        all is known and no created_at was supplied."""
        entry = self._gangs.get(key)
        if entry is not None:
            return self._build_path(key, entry, complete=False, now=now)
        hold = self._holds.get(key)
        admit = self._admits.get(key)
        anchor = created_at
        if anchor is None:
            if admit is not None:
                anchor = admit[0]
            elif hold is not None:
                anchor = hold[0]
            else:
                return None
        segments: dict[str, float] = {}
        if hold is not None:
            segments["handoff"] = max(hold[0] - anchor, 0.0)
            segments["held"] = max(now - max(hold[0], anchor), 0.0)
        elif admit is not None:
            segments["admission"] = max(admit[0] - anchor, 0.0)
            segments["handoff"] = max(now - max(admit[0], anchor), 0.0)
        else:
            segments["admission"] = max(now - anchor, 0.0)
        return {
            "gang": key,
            "bind_span_id": None,
            "segments": segments,
            "wall": {},
            "total": max(now - anchor, 0.0),
            "bind_latency": None,
            "queue_wait": admit[1] if admit is not None else None,
            "held_reason": hold[1] if hold is not None else None,
            "dominant": dominant_segment(segments, {}),
            "complete": False,
        }

    def summary(self) -> dict:
        return {
            "pending_gangs": len(self._gangs),
            "pending_holds": len(self._holds),
            "pending_admits": len(self._admits),
            "pending_solves": len(self._solves),
            "finalized": self.finalized,
            "dropped": self.dropped,
        }


def dominant_segment(segments: dict, wall: dict) -> str:
    """The named dominating segment: largest virtual-clock segment; a
    fully-instant path (virtual time never advanced) falls back to the
    largest wall-time interior segment, then 'bind'."""
    best, best_v = None, 0.0
    for name, v in segments.items():
        if v > best_v:
            best, best_v = name, v
    if best is not None:
        return best
    for name in INTERIOR_SEGMENTS:
        v = wall.get(name, 0.0)
        if v > best_v:
            best, best_v = name, v
    return best or "bind"


class CriticalPathObservatory:
    """Fleet-level aggregation of finalized critical paths: per-segment
    {count, sum, max} sketches, the
    grove_trace_critical_path_seconds{segment} histogram, and a bounded
    top-K slowest-gangs table. O(1) memory per observed path — this is
    what `tracing.mode: aggregate` keeps always-on."""

    def __init__(self, top_k: int = 10):
        self.top_k = top_k
        self.paths = 0
        self.totals_sum = 0.0
        self._seg: dict[str, dict] = {
            s: {"count": 0, "sum": 0.0, "max": 0.0} for s in SEGMENTS
        }
        self._wall: dict[str, float] = {s: 0.0 for s in INTERIOR_SEGMENTS}
        self._top: list = []  # min-heap of (total, seq, trimmed path)
        self._seq = itertools.count()

    def observe(self, path: dict, metrics=None) -> None:
        self.paths += 1
        self.totals_sum += path["total"]
        hist = None
        if metrics is not None:
            hist = metrics.histogram(
                "grove_trace_critical_path_seconds",
                "virtual seconds per gang critical-path segment "
                "(held/admission/handoff/solve interior/startup/barrier), "
                "telescoping to created->running per gang",
            )
        for seg, v in path["segments"].items():
            agg = self._seg.setdefault(
                seg, {"count": 0, "sum": 0.0, "max": 0.0}
            )
            agg["count"] += 1
            agg["sum"] += v
            agg["max"] = max(agg["max"], v)
            if hist is not None:
                hist.observe(v, segment=seg)
        for seg, v in (path.get("wall") or {}).items():
            if seg in self._wall:
                self._wall[seg] += v
        item = (
            path["total"], next(self._seq),
            {
                "gang": path["gang"],
                "total": round(path["total"], 9),
                "dominant": path["dominant"],
                "held_reason": path.get("held_reason"),
                "segments": {
                    k: round(v, 9) for k, v in path["segments"].items()
                },
            },
        )
        if len(self._top) < self.top_k:
            heapq.heappush(self._top, item)
        elif item[0] > self._top[0][0]:
            heapq.heapreplace(self._top, item)

    def top(self) -> list[dict]:
        """Slowest observed gangs, slowest first."""
        return [
            item[2]
            for item in sorted(self._top, key=lambda i: (-i[0], i[1]))
        ]

    def dominant(self) -> str:
        """The fleet-dominating segment (largest virtual sum; wall
        fallback mirrors the per-path rule)."""
        segs = {name: agg["sum"] for name, agg in self._seg.items()}
        return dominant_segment(segs, self._wall)

    def report(self) -> dict:
        return {
            "paths": self.paths,
            "dominant_segment": self.dominant(),
            "total_seconds_sum": round(self.totals_sum, 9),
            "segments": {
                name: {
                    "count": agg["count"],
                    "sum": round(agg["sum"], 9),
                    "max": round(agg["max"], 9),
                }
                for name, agg in self._seg.items()
            },
            "wall_seconds": {
                name: round(v, 9) for name, v in self._wall.items()
            },
            "top": self.top(),
        }
