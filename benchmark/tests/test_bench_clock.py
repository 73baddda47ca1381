"""The program's Tracer and torch.profiler on one clock, on the card.

Over a window as long as the benchmark's (51 s), a probe a second opens a
record_function range and, inside it, a Tracer span. The profiler's host
timestamp of the range (trace_start_ns + its start) has to lie between
the Tracer's reading just before the range and the span's t0, both put
on the Unix clock through epoch_ns, within 0.2 ms, from the first probe
to the last. The same probes timed with time.perf_counter (the Tracer's
clock before), anchored at the first probe, give the drift the old clock
had; `python3 -m pytest benchmark/tests -q -m card -s` prints both.
"""

import json
import time

import pytest

WINDOW_S = 51.0
LIMIT_NS = 0.2e6


def probe_window(seconds: float, cuda: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from grove_tpu_torch.observability.tracing import Tracer

    tracer = Tracer()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    x = torch.ones(1024, device="cuda" if cuda else "cpu")
    probes = []
    with profile(activities=acts) as prof:
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            pc = time.perf_counter()
            before = tracer._now_t()
            with record_function(f"probe{i}"):
                with tracer.span(f"probe{i}") as sp:
                    probes.append((before, sp, pc))
            x = x * 1.0001    # device work between the probes
            if pc >= t_end:
                break
            time.sleep(1.0)
            i += 1
    if cuda:
        torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()
              if e.name.startswith("probe")
              and e.device_type == torch.autograd.DeviceType.CPU}
    rows = []
    for before, sp, pc in probes:
        at_ns = start_ns + events[sp.name].time_range.start * 1e3
        rows.append((at_ns, tracer.epoch_ns + before * 1e9,
                     tracer.epoch_ns + sp.t0 * 1e9, pc))
    at0, _lo0, _hi0, pc0 = rows[0]
    outside = [max(lo - at, at - hi, 0.0) for at, lo, hi, _pc in rows]
    # the old clock: perf_counter, anchored at the first probe
    drift = [(at - at0) - (pc - pc0) * 1e9 for at, _lo, _hi, pc in rows]
    return {"probes": len(rows), "span_s": (rows[-1][0] - at0) / 1e9,
            "epoch_ns_outside_ms_max": max(outside) / 1e6,
            "epoch_ns_gap_ms_max": max(hi - lo for _a, lo, hi, _p in rows) / 1e6,
            "perf_counter_drift_ms_last": drift[-1] / 1e6,
            "perf_counter_drift_ms_max_abs": max(abs(d) for d in drift) / 1e6,
            "first_probe_outside_ms": outside[0] / 1e6}


@pytest.mark.card
def test_the_tracer_and_the_profiler_share_one_clock(card):
    out = probe_window(WINDOW_S, cuda=True)
    print("clock:", json.dumps(out))
    assert out["span_s"] >= WINDOW_S - 1.0
    assert out["epoch_ns_outside_ms_max"] * 1e6 <= LIMIT_NS, out
