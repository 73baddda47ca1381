"""The traced window: torch.profiler on the card, read into busy time,
kernel time by role, the device operations that took most time, and the
idle gaps labelled by what the host was doing.

Host spans come from two places: the benchmark's own `record_function`
ranges (`bench.*`, on the profiler's clock) and the program's Tracer spans
(on its own clock, `time.perf_counter`). The two clocks drift apart by up
to a solve's length over a long window, so a span is put on the
profiler's clock by the latest anchor before it: a Tracer span opened
inside a `record_function` range at the start of the window, then the
start of every `bench.*` range, whose perf_counter time is kept.
"""

from __future__ import annotations

import bisect
import heapq
import time
from contextlib import contextmanager

from . import roofline


class DeviceTrace:
    """Profile the card over a window. `range(name)` marks host work."""

    def __init__(self, enabled: bool, tracer=None):
        self.enabled = enabled
        self.tracer = tracer
        self.prof = None
        self._anchor_span = None
        self._marks: list[float] = []   # perf_counter at each range's start

    def __enter__(self):
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self._window = torch.profiler.record_function("bench.window")
            self._window.__enter__()
            if self.tracer is not None and self.tracer.enabled:
                with torch.profiler.record_function("bench.anchor"):
                    with self.tracer.span("bench.anchor") as sp:
                        self._anchor_span = sp
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self.t0
        if self.prof is not None:
            self._window.__exit__(None, None, None)
            self.prof.__exit__(*exc)
        return False

    @contextmanager
    def range(self, name: str):
        if self.prof is None:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            self._marks.append(time.perf_counter())
            yield

    def read(self, spans=()) -> dict:
        """busy_s, the kernels' device seconds and launches by role, the
        ten device operations that took most time, and the idle gaps' time
        summed by the innermost open span (program span first, else a
        bench range, else "no span"), ten largest."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        win = anchor = None
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.device_type == cuda:
                # a record_function range shows on the device's timeline
                # too, as a user annotation: no device work
                if not (getattr(ev, "is_user_annotation", False)
                        or ev.name.startswith("bench.")):
                    device.append((tr.start, tr.end, ev.name))
            elif ev.name == "bench.window":
                win = (tr.start, tr.end)
            elif ev.name == "bench.anchor":
                anchor = tr.start
            elif ev.name.startswith("bench."):
                host.append((tr.start, tr.end, ev.name, 1))
        if win is None:
            raise RuntimeError("the profiler recorded no bench.window range")
        w0, w1 = win
        names = roofline.kernel_names()
        by_role: dict[str, list] = {}
        by_name: dict[str, float] = {}
        clipped = []
        for s, e, name in device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            clipped.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            role = roofline.role_of(name, names)
            if role:
                acc = by_role.setdefault(role, [0.0, 0])
                acc[0] += (e - s) / 1e6
                acc[1] += 1
        clipped.sort()
        busy = []
        for s, e in clipped:
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        busy_s = sum(e - s for s, e in busy) / 1e6
        gaps = []
        prev = w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        if anchor is not None and self._anchor_span is not None:
            pairs = [(self._anchor_span.t0, anchor)]
            starts = sorted(h[0] for h in host)
            if len(starts) == len(self._marks):
                pairs += list(zip(self._marks, starts))
            pairs.sort()
            keys = [m for m, _ in pairs]
            for sp in spans:
                if sp.t1 is not None:
                    m, at = pairs[max(0, bisect.bisect_right(keys, sp.t0) - 1)]
                    off = at - m * 1e6
                    who = sp.attrs.get("controller")
                    host.append((sp.t0 * 1e6 + off, sp.t1 * 1e6 + off,
                                 f"{sp.name}:{who}" if who else sp.name, 2))
        idle = {label: us / 1e6
                for label, us in _idle_by_label(gaps, host).items()}
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])[:10]]
        return {
            "busy_s": busy_s,
            "traced_window_s": (w1 - w0) / 1e6,
            "kernels": {r: {"seconds": v[0], "launches": v[1]}
                        for r, v in by_role.items()},
            "device_ops": top(by_name),
            "idle_gaps": top(idle),
        }


def _idle_by_label(gaps, host) -> dict[str, float]:
    """The gaps' time (sorted, disjoint) split by the innermost host range
    open over each part of them: the program's spans (rank 2) before the
    benchmark's ranges (rank 1), the later start first within a rank;
    "no span" where none is open. A gap that runs from one solve's repair
    into the next solve's encode is so split between them."""
    bounds = sorted({x for h in host for x in (h[0], h[1])})
    order = sorted(host)
    heap: list = []
    segs = []
    j = 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(order) and order[j][0] <= a:
            s0, e0, name, rank = order[j]
            heapq.heappush(heap, (-rank, -s0, e0, name))
            j += 1
        while heap and heap[0][2] <= a:
            heapq.heappop(heap)
        segs.append((a, b, heap[0][3] if heap else "no span"))
    out: dict[str, float] = {}

    def add(name, t):
        out[name] = out.get(name, 0.0) + t

    i = 0
    for s, e in gaps:
        while i < len(segs) and segs[i][1] <= s:
            i += 1
        t, k = s, i
        while t < e:
            if k >= len(segs) or segs[k][0] >= e:
                add("no span", e - t)
                break
            a, b, name = segs[k]
            if a > t:
                add("no span", a - t)
                t = a
                continue
            x = min(b, e)
            add(name, x - t)
            t = x
            k += 1
    return out
