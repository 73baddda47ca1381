"""The program's Tracer spans read into per-layer metrics of the overload
cell: the window, the families' self time and the store's charges.

A window is the spans that start at or after the `bench.anchor` span,
which DeviceTrace opens in the program's Tracer as the window begins:
what was drained before it (set-up, warm-up) is left out. Span
ids are handed out one after another, so an id missing from the window
is a span the Tracer's ring evicted before a drain, unless a span of the
window names it as its parent (a span still open at the last drain). A
window with a lost span reads as None.

The program charges each outermost store call to the innermost open span
(attrs `store_seconds`, `store_calls`), or records it as a `store.call`
span where none is open. A family's self time is its spans' duration
less their child spans and less their own `store_seconds`, so the store,
kubelet, manager and controller families never count a second twice.
"""

from __future__ import annotations

STORE_CALL = "store.call"
KUBELET = ("kubelet.tick", "kubelet.heartbeat", "kubelet.pod_start",
           "kubelet.pod_ready")
MANAGER = ("harness.settle", "manager.round", "manager.drain_events",
           "manager.flush_writes")
CONTROLLER = ("manager.reconcile",)


def window(spans) -> list | None:
    """The spans from the bench.anchor span on; None where there is no
    anchor or where spans of the window were lost."""
    anchor = next((sp for sp in spans if sp.name == "bench.anchor"), None)
    if anchor is None:
        return None
    inside = [sp for sp in spans if sp.t0 >= anchor.t0]
    ids = {sp.span_id for sp in inside}
    open_at_drain = {sp.parent_id for sp in inside}
    for sid in range(anchor.span_id, max(ids) + 1):
        if sid not in ids and sid not in open_at_drain:
            return None
    return inside


def self_seconds(spans, names) -> float:
    """Summed self time of the spans named in `names`: duration less the
    child spans and less the span's own store charges."""
    child: dict[int, float] = {}
    for sp in spans:
        if sp.parent_id is not None:
            child[sp.parent_id] = child.get(sp.parent_id, 0.0) + (sp.t1 - sp.t0)
    return sum((sp.t1 - sp.t0) - child.get(sp.span_id, 0.0)
               - sp.attrs.get("store_seconds", 0.0)
               for sp in spans if sp.name in names)


def store_seconds(spans) -> float:
    """The store's time: every span's charges plus the store.call spans."""
    return sum(sp.attrs.get("store_seconds", 0.0) if sp.name != STORE_CALL
               else sp.t1 - sp.t0 for sp in spans)


def _per_gang(run, seconds_of, present) -> float | None:
    spans = window(run.spans) if run.spans else None
    if not spans or not run.bound or not any(present(sp) for sp in spans):
        return None
    return 1e3 * seconds_of(spans) / run.bound


def family_ms_per_gang(run, names, marker: str) -> float | None:
    """Self time of the family `names` in the window, ms per gang bound;
    None where no `marker` span ran there (a program without the span)."""
    return _per_gang(run, lambda spans: self_seconds(spans, names),
                     lambda sp: sp.name == marker)


def store_ms_per_gang(run) -> float | None:
    """The store's time in the window, ms per gang bound; None where the
    program charges no store call."""
    return _per_gang(run, store_seconds,
                     lambda sp: sp.name == STORE_CALL
                     or "store_seconds" in sp.attrs)
