"""The elastic-serving regime (`--diurnal`): the counterpart of
bench.py's `bench_diurnal`."""

from __future__ import annotations

import json
import sys
import time

from .shapes import backend_name, p50, regime_device


def bench_diurnal(args, device=None) -> int:
    """Elastic-serving bench regime (`--diurnal`, ROADMAP item 4): a
    multi-hour virtual diurnal trace — 10x base..peak swing, seeded
    noise, a spike on each cycle's rising edge — drives the FULL serving
    loop: the kubelet reports per-pod utilization each tick, the HPA
    sync runs on the validated `autoscaler.*` cadence, scale writes land
    on the PCSG/PodClique scale subresources, the reconcilers
    create/delete scaled PodGangs, and the scheduler re-places scale-ups
    against the vacating gangs' own reservations.

    The run spans TWO full diurnal cycles, so the trough genuinely
    scales the fleet down and the second ramp re-creates the same-named
    scaled gangs — the reservation-reuse hit path the scheduler must
    serve near-free and topology-stable.

    Reported (all latencies in VIRTUAL seconds — deterministic, immune
    to this host's wall noise):
      - end-to-end scale-up latency: each under-capacity episode (a
        tier's ready pods below what current demand requires at the
        HPA's effective target) from the demand step to capacity
        restored — detection + sync + reconcile + solve + bind + pod
        startup; p50/p99 over episodes;
      - starved intervals: episodes longer than the grace window (one
        sync interval + 3 steps) — the bench FAILS (exit 1) on any;
      - placement-score drift: max - min of the mean placement score
        sampled across the day (reuse keeps re-placements where they
        were, so the on-side drift should stay near zero);
      - reservation-reuse hit rate (exit 1 when zero hits — a vacuous
        run must not read as coverage).

    The reuse-on and reuse-off harnesses run INTERLEAVED step by step
    (per the bench-noise discipline: this host's load arrives in bursts,
    so A/B wall comparisons must share them) and both sides' numbers
    ship in the JSON."""
    device = regime_device(args, device)
    import math as _math

    from ..api import constants as _constants
    from ..api.meta import ObjectMeta as Meta
    from ..api.podgang import PodGang
    from ..api.types import (
        AutoScalingConfig,
        Container,
        Pod,
        PodCliqueScalingGroupConfig,
        PodCliqueSet,
        PodCliqueSetSpec,
        PodCliqueSetTemplateSpec,
        PodCliqueSpec,
        PodCliqueTemplateSpec,
        PodSpec,
    )
    from ..cluster import make_nodes
    from ..controller import Harness
    from ..tuning import tune_gc

    small = args.small
    hours = min(args.diurnal_hours, 2.0) if small else args.diurnal_hours
    duration = hours * 3600.0
    period = duration / 2.0  # two full cycles per run
    step = 30.0 if small else 20.0
    sync, stabilization, tolerance = 60.0, 300.0, 0.1
    target = 0.7
    base, peak = (30.0, 300.0) if small else (120.0, 1200.0)
    # one spike per cycle, riding the ramp (x1.4 on top of the curve)
    spikes = [
        {"at_seconds": round(c * period + 0.30 * period, 1),
         "duration_seconds": 8 * step, "multiplier": 1.4}
        for c in (0, 1)
    ]
    #: serving tiers — the reference's disaggregated roles: prefill
    #: (compute-bound PCSG), decode (memory-bound PCSG), router (a
    #: standalone clique whose HPA scales pod count directly, covering
    #: the PodClique-target path). pods = pods per scale unit (PCSG
    #: replica gang size, or 1 for the clique-target tier).
    tiers = {
        "prefill": dict(shape="prefill", rps=15.0, frac=0.45, pods=4,
                        min_r=1, max_r=6 if small else 18, pcsg=True),
        "decode": dict(shape="decode", rps=30.0, frac=0.45, pods=4,
                       min_r=1, max_r=4 if small else 10, pcsg=True),
        "router": dict(shape="router", rps=30.0 if small else 60.0,
                       frac=0.10, pods=1, min_r=2, max_r=4 if small else 6,
                       pcsg=False),
    }
    serving_cfg = {
        "enabled": True,
        "trace": {"base_rps": base, "peak_rps": peak,
                  "period_seconds": period, "noise": 0.02,
                  "sample_seconds": step, "spikes": spikes},
        "workloads": [
            {"clique": name, "shape": t["shape"],
             "rps_per_replica": t["rps"], "demand_fraction": t["frac"]}
            for name, t in tiers.items()
        ],
    }

    def mk_harness(reuse: bool) -> Harness:
        h = Harness(
            device=device,
            nodes=make_nodes(
                64 if small else 96, racks_per_block=4, hosts_per_rack=4,
                allocatable={"cpu": 4.0, "memory": 32.0, "tpu": 0.0},
            ),
            config={
                "serving": serving_cfg,
                "autoscaler": {
                    "tolerance": tolerance,
                    "sync_interval_seconds": sync,
                    "scale_down_stabilization_seconds": stabilization,
                    "metrics_max_age_seconds": 3 * sync,
                },
                "solver": {"reservation_reuse": reuse},
            },
        )
        cliques, sgs = [], []
        for name, t in tiers.items():
            sc = AutoScalingConfig(
                min_replicas=t["min_r"], max_replicas=t["max_r"],
                target_utilization=target,
            )
            pod_spec = PodSpec(
                containers=[Container(name="m", resources={"cpu": 1.0})]
            )
            if t["pcsg"]:
                cliques.append(PodCliqueTemplateSpec(
                    name=name,
                    spec=PodCliqueSpec(replicas=t["pods"], pod_spec=pod_spec),
                ))
                sgs.append(PodCliqueScalingGroupConfig(
                    name=f"{name}sg", clique_names=[name], replicas=1,
                    min_available=1, scale_config=sc,
                ))
            else:
                cliques.append(PodCliqueTemplateSpec(
                    name=name,
                    spec=PodCliqueSpec(
                        replicas=t["min_r"], scale_config=sc,
                        pod_spec=pod_spec,
                    ),
                ))
        h.apply(PodCliqueSet(
            metadata=Meta(name="serve"),
            spec=PodCliqueSetSpec(
                replicas=1,
                template=PodCliqueSetTemplateSpec(
                    cliques=cliques,
                    pod_clique_scaling_group_configs=sgs,
                ),
            ),
        ))
        h.settle()
        return h

    sides = {"on": mk_harness(True), "off": mk_harness(False)}
    tune_gc()

    #: under-capacity detection uses the HPA's EFFECTIVE target: the
    #: loop legitimately holds anywhere inside the tolerance band, so
    #: the guaranteed capacity floor is demand / (target * (1 + tol)).
    #: The pod-count core is the serving model's own oracle
    #: (WorkloadShape.required_pods); the bench only adds the HPA-side
    #: unit rounding (gang size) and min/max replica clamps.
    from ..serving import WorkloadShape

    target_eff = target * (1.0 + tolerance)
    shapes = {
        name: WorkloadShape(clique=name, shape=t["shape"],
                            rps_per_replica=t["rps"],
                            demand_fraction=t["frac"])
        for name, t in tiers.items()
    }

    def required_pods(name: str, tier: dict, demand: float) -> int:
        want = shapes[name].required_pods(demand, target_eff)
        units = _math.ceil(want / tier["pods"] - 1e-9)
        units = min(max(units, tier["min_r"]), tier["max_r"])
        return units * tier["pods"]

    def tier_ready(h) -> dict[str, int]:
        counts = dict.fromkeys(tiers, 0)
        serving = h.cluster.serving
        for p in h.store.scan(Pod.KIND):
            if not p.status.ready or p.metadata.deletion_timestamp is not None:
                continue
            clique = p.metadata.labels.get(_constants.LABEL_PODCLIQUE, "")
            if not clique:
                continue
            tmpl = serving.template_of(
                h.store, p.metadata.namespace, clique
            )
            if tmpl in counts:
                counts[tmpl] += 1
        return counts

    grace = sync + 3 * step
    n_steps = int(round(duration / step))
    track = {
        side: {
            "episode_start": dict.fromkeys(tiers),
            "episodes": [],
            "scores": [],
            "walls": [],
        }
        for side in sides
    }
    for _ in range(n_steps):
        # interleaved per the bench-noise discipline: a host-load burst
        # lands on both sides of the A/B, not on one
        for side, h in sides.items():
            st = track[side]
            t0 = time.perf_counter()
            h.advance(step)
            h.maybe_autoscale()
            h.compact_events()
            st["walls"].append(time.perf_counter() - t0)
            now = h.clock.now()
            demand = h.cluster.serving.demand(now)
            ready = tier_ready(h)
            for name, t in tiers.items():
                lagging = ready[name] < required_pods(name, t, demand)
                start = st["episode_start"][name]
                if lagging and start is None:
                    st["episode_start"][name] = now
                elif not lagging and start is not None:
                    st["episodes"].append(now - start)
                    st["episode_start"][name] = None
            scores = [
                g.status.placement_score
                for g in h.store.scan(PodGang.KIND)
                if g.status.placement_score is not None
            ]
            if scores:
                st["scores"].append(sum(scores) / len(scores))
    for side, h in sides.items():
        # an episode still open at end of trace is a failure to catch up
        now = h.clock.now()
        for name, start in track[side]["episode_start"].items():
            if start is not None:
                track[side]["episodes"].append(now - start)

    def side_stats(side: str) -> dict:
        h = sides[side]
        st = track[side]
        episodes = sorted(st["episodes"])

        def pct(p):
            if not episodes:
                return 0.0
            return episodes[min(len(episodes) - 1,
                                int(round(p * (len(episodes) - 1))))]

        reuse_ctr = h.cluster.metrics.counter(
            "grove_scheduler_reservation_reuse_total"
        )
        hits = reuse_ctr.value(outcome="hit")
        attempts = reuse_ctr.total()
        scale_ctr = h.cluster.metrics.counter(
            "grove_autoscaler_scale_events_total"
        )
        walls = st["walls"]
        scores = st["scores"]
        return {
            "scaleup_events": len(episodes),
            "scaleup_p50_seconds": round(pct(0.50), 1),
            "scaleup_p99_seconds": round(pct(0.99), 1),
            "starved_intervals": sum(1 for e in episodes if e > grace),
            "placement_score_drift": (
                round(max(scores) - min(scores), 4) if scores else 0.0
            ),
            "placement_score_mean": (
                round(sum(scores) / len(scores), 4) if scores else 0.0
            ),
            "reservation_reuse_hits": int(hits),
            "reservation_reuse_attempts": int(attempts),
            "reservation_reuse_hit_rate": (
                round(hits / attempts, 3) if attempts else 0.0
            ),
            "scale_ups": int(scale_ctr.value(direction="up")),
            "scale_downs": int(scale_ctr.value(direction="down")),
            "stabilized_holds": int(
                h.cluster.metrics.counter(
                    "grove_autoscaler_stabilized_holds_total"
                ).total()
            ),
            "settle_wall_p50_seconds": (
                round(p50(walls), 4) if walls else 0.0
            ),
        }

    on = side_stats("on")
    off = side_stats("off")
    out = {
        "metric": "elastic serving: diurnal trace through the full "
        f"control plane ({hours:g} virtual hours, {peak / base:g}x swing, "
        "prefill/decode/router tiers)",
        "value": on["scaleup_p50_seconds"],
        "unit": "virtual seconds (p50 end-to-end scale-up)",
        "vs_baseline": 0.0,
        "diurnal_virtual_hours": hours,
        "diurnal_steps": n_steps,
        "diurnal_step_seconds": step,
        "load_swing": round(peak / base, 1),
        "spikes": len(spikes),
        "hpa_sync_interval_seconds": sync,
        "scale_down_stabilization_seconds": stabilization,
        "starved_interval_grace_seconds": grace,
        **on,
        "reuse_off": off,
        "backend": backend_name(device),
        "engine": "single",
    }
    print(json.dumps(out))
    ok = on["starved_intervals"] == 0 and on["reservation_reuse_hits"] > 0
    if on["starved_intervals"]:
        print(
            f"DIURNAL BENCH FAILURE: {on['starved_intervals']} starved "
            f"interval(s) (> {grace:g}s under capacity)", file=sys.stderr,
        )
    if on["reservation_reuse_hits"] == 0:
        print(
            "DIURNAL BENCH FAILURE: zero reservation-reuse hits — the "
            "trough/ramp cycle never exercised the reuse path",
            file=sys.stderr,
        )
    if off["starved_intervals"]:
        # informational: the off side is the comparison arm, not the gate
        print(
            f"diurnal reuse-off side: {off['starved_intervals']} starved "
            "interval(s)", file=sys.stderr,
        )
    return 0 if ok else 1
