"""The streaming-admission regime (`--stream`): the counterparts of
bench.py's `_stream_schedule`, `_stream_run` and `bench_stream`."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .controlplane import _churn_pcs, _trace_critical_path
from .shapes import backend_name, interleaved_ab, regime_device


def _stream_schedule(rate: float, duration: float, batch_dt: float,
                     burst_every: float, burst_mult: int,
                     seed: int) -> list[int]:
    """Pre-generated arrival schedule (gangs per batch_dt step): Poisson
    at `rate` with a `burst_mult`x burst landing every `burst_every`
    virtual seconds. Generated ONCE per rung and replayed verbatim on
    BOTH A/B sides, so the comparison sees the identical offered load."""
    rng = np.random.default_rng(seed)
    n_batches = max(1, int(round(duration / batch_dt)))
    sched = [int(rng.poisson(rate * batch_dt)) for _ in range(n_batches)]
    if burst_every > 0 and burst_mult > 1:
        step = max(1, int(round(burst_every / batch_dt)))
        for i in range(step - 1, n_batches, step):
            sched[i] += int(round(burst_mult * rate * batch_dt))
    return sched


def _stream_run(h, schedule: list[int], batch_dt: float,
                steady_batch: int, population: int) -> dict:
    """Drive one pre-generated arrival schedule against a warm harness
    and measure wall-clock creation->Scheduled latency per gang (the
    churn_workload convention: the bind lands inside the batch's settle,
    so a gang's latency includes queueing behind the batch and any
    carryover backlog).

    Gangs the streaming front sheds (SCHEDULED False with reason
    DeadlineExceeded) leave the latency sample at first observation —
    a shed is a structured refusal, not a slow bind — and are counted
    separately; a shed gang that re-admits and binds later counts as
    `bound_after_shed`, still censored from the percentile (its latency
    is a shed-then-readmit lifecycle, not an admitted bind). On the
    round-draining side nothing sheds, so every created gang is either
    bound or still pending at the end — the two sides' samples reconcile
    against the same created total either way.

    Warmup covers the solver bucket ladder up to the STEADY batch only,
    on both sides: a 10x burst then lands as one monolithic (cold-
    bucket) solve under round-draining but stays inside the warmed
    ladder under micro-batching — that asymmetry is the measured
    phenomenon, not a harness artifact."""
    import collections

    from ..api.meta import get_condition
    from ..api.naming import base_podgang_name
    from ..api.podgang import PodGang, PodGangConditionType
    from ..observability.explain import UnsatCode

    store = h.store
    prefix = f"stream-{store.last_seq}"
    alive: collections.deque[str] = collections.deque()
    pending: dict[str, float] = {}
    shed_pending: set[str] = set()
    latencies: list[float] = []
    created = sheds_observed = bound_after_shed = 0
    seq = 0
    measured_wall = 0.0

    ladder = []
    size = 1
    while size < steady_batch:
        ladder.append(size)
        size *= 2
    warmup = ladder + [steady_batch] * 2

    def sample(now: float, measuring: bool) -> None:
        nonlocal sheds_observed, bound_after_shed
        done = []
        for gname, t_created in pending.items():
            gang = store.peek(PodGang.KIND, "default", gname)
            if gang is None:
                done.append(gname)
                continue
            cond = get_condition(
                gang.status.conditions,
                PodGangConditionType.SCHEDULED.value,
            )
            if cond is None:
                continue
            if cond.status == "True":
                if measuring:
                    if gname in shed_pending:
                        bound_after_shed += 1
                    else:
                        latencies.append(now - t_created)
                done.append(gname)
            elif cond.reason == UnsatCode.DEADLINE.value \
                    and gname not in shed_pending:
                shed_pending.add(gname)
                if measuring:
                    sheds_observed += 1
        for gname in done:
            del pending[gname]
            shed_pending.discard(gname)

    for b in range(-len(warmup), len(schedule)):
        measuring = b >= 0
        this_batch = schedule[b] if b >= 0 else warmup[b + len(warmup)]
        t0 = time.perf_counter()
        for _ in range(this_batch):
            name = f"{prefix}-{seq}"
            seq += 1
            h.apply(_churn_pcs(name))
            alive.append(name)
            pending[base_podgang_name(name, 0)] = time.perf_counter()
            if measuring:
                created += 1
        while len(alive) > population:
            victim = alive.popleft()
            store.delete("PodCliqueSet", "default", victim)
            gname = base_podgang_name(victim, 0)
            pending.pop(gname, None)
            shed_pending.discard(gname)
        h.clock.advance(batch_dt)
        h.settle()
        h.compact_events()
        now = time.perf_counter()
        if measuring:
            measured_wall += now - t0
        sample(now, measuring)
    # drain: fire the front's window timers / the scheduler's retry
    # timers so late admits and post-storm re-admissions land
    for _ in range(6):
        t0 = time.perf_counter()
        h.advance(1.0)
        sample(time.perf_counter(), True)
        measured_wall += time.perf_counter() - t0
    latencies.sort()

    def pct(p):
        if not latencies:
            return 0.0
        return latencies[min(len(latencies) - 1,
                             int(round(p * (len(latencies) - 1))))]

    return {
        "created": created,
        "bound": len(latencies),
        "sheds_observed": sheds_observed,
        "bound_after_shed": bound_after_shed,
        "unbound_final": len(pending),
        "p50_bind_seconds": round(pct(0.50), 4),
        "p99_bind_seconds": round(pct(0.99), 4),
        "measured_wall": measured_wall,
        "sustained_gangs_per_sec": (
            round((len(latencies) + bound_after_shed) / measured_wall, 1)
            if measured_wall else 0.0
        ),
    }


def bench_stream(args, device=None) -> int:
    """Streaming-admission A/B regime (`--stream`, ROADMAP item 1's
    continuous scheduling): the max sustained gang arrival rate
    (gangs/sec) whose p99 bind latency stays under the DECLARED SLO
    (--stream-slo wall seconds), under Poisson arrivals with a periodic
    10x burst — the streaming admission front (micro-batch windows +
    deadline-budget shedding; grove_tpu/streaming) against classic
    round-based draining, interleaved A/B on the identical pre-generated
    arrival schedule per rung.

    The rate ladder runs 1x/2x/4x the base rate; a side's "max
    sustained rate at SLO" is the highest rung whose measured p99 (over
    ADMITTED binds — sheds are structured refusals, reported separately)
    meets the SLO. Exit is nonzero when the stream side fails its SLO at
    the base rung or sustains a lower max rate than round-draining: the
    front exists to keep admitted-work latency bounded under overload by
    shedding the excess with DeadlineExceeded, and a regression in
    either direction is a contract violation."""
    device = regime_device(args, device)
    from ..cluster import make_nodes
    from ..controller import Harness
    from ..tuning import tune_gc

    small = args.small
    num_nodes = 128 if small else min(args.nodes, 512)
    base_rate = min(args.churn_rate, 16.0) if small else min(
        args.churn_rate, 64.0
    )
    duration = min(args.churn_duration, 5.0) if small else min(
        args.churn_duration, 20.0
    )
    batch_dt = 0.5
    slo = args.stream_slo
    rates = [base_rate, 2 * base_rate, 4 * base_rate]
    tune_gc()

    def stream_config(rate: float) -> dict:
        batch = max(1, int(round(rate * batch_dt)))
        # sized against the burst shape: the queue cap holds ~2 seconds
        # of offered load (a 10x burst overflows it and SHEDS), the
        # micro-batch matches one steady batch (stream throughput equals
        # round throughput when nothing is burning), and the virtual
        # deadline budget spans a few batch intervals
        return {
            "stream": {
                "enabled": True,
                "slo_seconds": 8 * batch_dt,
                "window_min_seconds": 0.1,
                "window_max_seconds": 1.0,
                "max_batch_gangs": batch,
                "queue_cap_gangs": 4 * batch,
                "brownout_depth_fraction": 0.5,
                "readmit_depth_fraction": 0.25,
            }
        }

    #: --trace composition: every rung's stream/round side gets its own
    #: full-ring tracer (its own Perfetto process in the export), the
    #: per-side fleet critical-path report rides in the rung dict, and
    #: the telescoping/non-vacuity failures gate the exit code alongside
    #: the SLO scorecard. Both sides trace, so the A/B stays symmetric.
    trace_groups: dict = {}
    trace_failures: list[str] = []
    rungs = []
    for rung_idx, rate in enumerate(rates):
        batch = max(1, int(round(rate * batch_dt)))
        population = min(10 * batch, 2 * num_nodes)
        schedule = _stream_schedule(
            rate, duration, batch_dt, burst_every=max(2.0, duration / 2),
            burst_mult=10, seed=17 + rung_idx,
        )

        def measure(stream_on: bool):
            cfg: dict = dict(stream_config(rate)) if stream_on else {}
            if args.trace:
                cfg["tracing"] = {"enabled": True}
            h = Harness(
                device=device,
                nodes=make_nodes(
                    num_nodes,
                    allocatable={"cpu": 32.0, "memory": 128.0,
                                 "tpu": 8.0},
                ),
                config=cfg or None,
            )
            h.settle()
            out = _stream_run(h, schedule, batch_dt, batch, population)
            if stream_on:
                m = h.cluster.metrics
                out["front_sheds"] = int(m.counter(
                    "grove_stream_shed_total",
                    "gangs shed by the streaming front",
                ).total())
                out["front_readmitted"] = int(m.counter(
                    "grove_stream_readmitted_total",
                    "shed gangs re-admitted",
                ).total())
            if args.trace:
                side = "stream" if stream_on else "round"
                report, fails = _trace_critical_path(
                    h.cluster.tracer, h.cluster.metrics,
                    binds=out["bound"],
                    label=f"{side} @ {rate:g} gangs/s",
                )
                out["critical_path"] = report
                trace_failures.extend(fails)
                trace_groups[f"{side}-{rate:g}gps"] = h.cluster.tracer
            return out

        (s_runs, r_runs) = interleaved_ab(
            lambda _i: measure(True), lambda _i: measure(False), 1,
        )
        stream_r, round_r = s_runs[0], r_runs[0]
        rungs.append({
            "offered_gangs_per_sec": rate,
            "stream": stream_r,
            "round": round_r,
        })

    def max_rate(side: str) -> float:
        best = 0.0
        for rung in rungs:
            if rung[side]["bound"] and \
                    rung[side]["p99_bind_seconds"] <= slo:
                best = rung["offered_gangs_per_sec"]
        return best

    stream_max, round_max = max_rate("stream"), max_rate("round")
    top = rungs[-1]
    # the bench verdicts ride the SLO scorecard schema (one verdict
    # vocabulary across bench, chaos, and the live engine — ROADMAP
    # item 3): each contract is a static_entry whose breach/ok verdict
    # IS the exit-code decision below
    from ..observability.slo import (
        VERDICT_BREACH, compose_scorecard, static_entry,
    )
    base_p99 = rungs[0]["stream"]["p99_bind_seconds"]
    card = compose_scorecard([
        static_entry(
            "stream-base-p99", "bind_latency_p99", base_p99,
            threshold=slo, unit="seconds",
            offered_gangs_per_sec=rates[0],
        ),
        static_entry(
            "stream-max-rate", "sustained_rate", stream_max,
            threshold=round_max, unit="gangs/sec", higher_is_better=True,
            round_max_gangs_per_sec=round_max,
        ),
        static_entry(
            "stream-sheds", "shed_count",
            float(top["stream"].get("front_sheds", 0)),
            unit="gangs", readmitted=top["stream"].get(
                "front_readmitted", 0
            ),
        ),
    ])
    out = {
        "metric": f"streaming admission max sustained rate at p99 <= "
        f"{slo:g}s SLO ({num_nodes} nodes, Poisson + 10x bursts)",
        "value": stream_max,
        "unit": "gangs/sec",
        "vs_baseline": (
            round(stream_max / round_max, 2) if round_max else 0.0
        ),
        "round_max_gangs_per_sec": round_max,
        "p99_slo_seconds": slo,
        "rate_ladder": rates,
        "rungs": rungs,
        "top_rung_stream_p99": top["stream"]["p99_bind_seconds"],
        "top_rung_round_p99": top["round"]["p99_bind_seconds"],
        "scorecard": card,
        "backend": backend_name(device),
        "engine": "single",
    }
    if args.trace:
        from ..observability.tracing import chrome_trace

        with open(args.trace, "w") as fh:
            json.dump(chrome_trace(trace_groups), fh)
            fh.write("\n")
        n_spans = sum(len(v.finished) for v in trace_groups.values())
        print(f"wrote {n_spans} spans to {args.trace}", file=sys.stderr)
        # fleet breakdown at the TOP rung (the overload point the bench
        # exists to characterize): stream vs round, where the latency
        # went on each side — also echoed to stderr so a CI log shows
        # the dominating segment without parsing the JSON
        out["critical_path_breakdown"] = {
            "offered_gangs_per_sec": rates[-1],
            "stream": top["stream"].get("critical_path"),
            "round": top["round"].get("critical_path"),
        }
        print(json.dumps(
            {"critical_path_breakdown": out["critical_path_breakdown"]}
        ), file=sys.stderr)
    print(json.dumps(out))
    by_name = {e["slo"]: e for e in card["slos"]}
    if by_name["stream-base-p99"]["verdict"] == VERDICT_BREACH:
        print(
            f"STREAM BENCH FAILURE: p99 {base_p99}s > SLO {slo}s at "
            f"the base rate {rates[0]:g} gangs/s",
            file=sys.stderr,
        )
    if by_name["stream-max-rate"]["verdict"] == VERDICT_BREACH:
        print(
            f"STREAM BENCH FAILURE: stream sustains {stream_max:g} "
            f"gangs/s at SLO but round-draining sustains {round_max:g}",
            file=sys.stderr,
        )
    for f in trace_failures:
        print(f"STREAM BENCH FAILURE: {f}", file=sys.stderr)
    if card["verdict"] == VERDICT_BREACH or trace_failures:
        return 1
    return 0
