"""The continuous-defragmentation regime (`--defrag`): the counterpart
of bench.py's `bench_defrag`."""

from __future__ import annotations

import json
import sys
import time

from .shapes import backend_name, interleaved_ab, regime_device, wall_stats


def bench_defrag(args, device=None) -> int:
    """Continuous-defragmentation long-churn regime (`--defrag`, ROADMAP
    item 3): a seeded arrival/departure stream of whole-node gangs
    (each pod fills a node, so a gang is a PAIR of nodes and its
    placement score is the narrowness of the domain containing the
    pair) against a near-full fleet. Random departures punch node-sized
    holes into random racks; arrivals that find no rack-local pair of
    holes must span racks or blocks — placement-score drift IS the
    fragmentation. The defrag-ON side runs Harness.maybe_defrag on the
    config cadence; the OFF side runs the identical op stream untouched.

    Both sides execute the SAME pre-generated op sequence INTERLEAVED
    step by step (the shared interleaved_ab/wall_stats helpers — this
    host's walls swing ~2x run-to-run, so each side's settle walls ship
    as min/median/max and a load burst lands on both sides of a pair).

    Gates (exit nonzero on any):
      - on-side drift (initial-window mean - final-window mean score)
        within --defrag-band;
      - the OFF side actually degrades by more than the band AND ends
        below the on side — otherwise the A/B is vacuous;
      - defrag evictions/hour under the configured
        defrag.max_evictions_per_hour bound;
      - make-before-break coverage: > 0 migration-ticket attempts, and
        the hit rate ships in the JSON;
      - ZERO full re-encodes (state_full_uploads / fused / split
        launches) attributable to defrag engine calls after the first
        sweep — the what-if contract, measured from the controller's
        dispatch attribution."""
    device = regime_device(args, device)
    import random as _random

    from ..api.meta import ObjectMeta as Meta
    from ..api.podgang import PodGang
    from ..api.types import (
        Container,
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
    hours = min(args.defrag_hours, 1.0) if small else args.defrag_hours
    step = 30.0
    n_steps = int(round(hours * 3600.0 / step))
    num_nodes = 24 if small else 48
    #: the fragmenting mix (every pod fills a whole 1-cpu node, so a
    #: gang IS a node set and its score is that set's narrowness): TRIO
    #: gangs (3 nodes) + PAIR gangs (2) + FILL singles (1) tile the
    #: 4-host racks EXACTLY at start (trio+fill racks, pair+pair racks
    #: — staged apply, descending size, so the initial state is
    #: optimally packed and drift starts from zero entropy). Churn then
    #: fragments structurally: replacements arrive one step LATE, so a
    #: departure's hole stays open across a step and same-batch smaller
    #: arrivals (fills sort — and place — first) bite chunks out of it;
    #: the late trio/pair replacement must take whatever scattered
    #: nodes remain. Without the size mix AND the lag every replacement
    #: refills its predecessor's hole exactly and nothing ever
    #: fragments (measured).
    trios = 4 if small else 8
    pairs = 4 if small else 8
    solos = 4 if small else 8
    #: churn scales with the pool (same per-gang lifetime both sizes):
    #: less relative churn both fragments less AND starves defrag of
    #: the transient rack-local holes it re-packs into
    churn_per_step = 2 if small else 4
    sync = 60.0                         # defrag sweep cadence
    #: evictions/hour ceiling — scaled with the churn it must repair
    #: (at the full size the 4-gang/step stream fragments faster than
    #: 60 moves/hour can re-pack, measured: drift 0.09 rate-limited
    #: vs 0.03 with headroom)
    evict_bound = 60.0 if small else 150.0
    defrag_cfg = {
        "sync_interval_seconds": sync,
        "min_score_gain": 0.05,
        "migration_cost_score": 0.02,
        "max_moves_per_sweep": 6,
        "max_evictions_per_hour": evict_bound,
        "candidates_per_sweep": 32,
    }
    sizes = {"trio": 3, "pair": 2, "fill": 1}

    def pcs(name):
        pods = sizes[name.split("-")[0]]
        return PodCliqueSet(
            metadata=Meta(name=name),
            spec=PodCliqueSetSpec(
                replicas=1,
                template=PodCliqueSetTemplateSpec(cliques=[
                    PodCliqueTemplateSpec(
                        name="w",
                        spec=PodCliqueSpec(
                            replicas=pods,
                            pod_spec=PodSpec(containers=[
                                Container(
                                    name="m", resources={"cpu": 1.0}
                                )
                            ]),
                        ),
                    )
                ]),
            ),
        )

    def mk_harness(defrag_on: bool) -> Harness:
        return Harness(
            device=device,
            nodes=make_nodes(
                num_nodes, racks_per_block=2, hosts_per_rack=4,
                allocatable={"cpu": 1.0, "memory": 8.0, "tpu": 0.0},
            ),
            config={
                "defrag": {"enabled": defrag_on, **defrag_cfg},
            },
        )

    # pre-generate the seeded op stream ONCE so both sides execute the
    # identical arrivals/departures in the identical order. Each
    # departure is replaced by a fresh-named gang of the SAME kind (the
    # offered load shape is stationary; only placement quality drifts)
    # arriving one step LATER — ops[i] = (born_i, doomed_i) with
    # born_i = replacements for doomed_{i-1}.
    rng = _random.Random(42)
    stages = [
        [f"trio-{i}" for i in range(trios)],
        [f"pair-{i}" for i in range(pairs)],
        [f"fill-{i}" for i in range(solos)],
    ]
    alive: list[str] = [n for stage in stages for n in stage]
    next_id = 100
    ops: list[tuple[list[str], list[str]]] = []
    carry: list[str] = []
    for _ in range(n_steps):
        born = carry
        alive.extend(born)
        doomed = sorted(
            rng.sample(sorted(alive), min(churn_per_step, len(alive)))
        )
        carry = []
        for name in doomed:
            kind = name.split("-")[0]
            carry.append(f"{kind}-{next_id}")
            next_id += 1
            alive.remove(name)
        ops.append((born, doomed))

    sides = {"on": mk_harness(True), "off": mk_harness(False)}
    import io as _io

    sides["on"].defrag.log.stream = _io.StringIO()  # moves go to JSON
    for h in sides.values():
        # staged by descending gang size: each stage packs into the
        # residue of the previous, producing the exact rack tiling
        for stage in stages:
            for name in stage:
                h.apply(pcs(name))
            h.settle()
    tune_gc()

    track = {
        side: {"scores": [], "walls": []} for side in sides
    }
    whatif_baseline = {}  # attribution snapshot after the first sweep

    def fleet_score(h) -> float:
        scores = [
            g.status.placement_score
            for g in h.store.scan(PodGang.KIND)
            if g.status.placement_score is not None
        ]
        return sum(scores) / len(scores) if scores else 0.0

    def step_side(side: str, i: int):
        h = sides[side]
        born, doomed = ops[i]
        t0 = time.perf_counter()
        for name in born:  # last step's replacements, one step late
            h.apply(pcs(name))
        h.settle()
        for name in doomed:
            h.store.delete(PodCliqueSet.KIND, "default", name)
        h.settle()
        h.advance(step)
        swept = h.maybe_defrag()
        h.compact_events()
        wall = time.perf_counter() - t0
        if side == "on" and swept and "kinds" not in whatif_baseline:
            # steady-state window starts after the FIRST sweep (engine
            # birth may legitimately pay one full upload there)
            whatif_baseline["kinds"] = dict(h.defrag.dispatch_kinds)
        st = track[side]
        st["walls"].append(wall)
        st["scores"].append(fleet_score(h))
        return wall

    interleaved_ab(
        lambda i: step_side("on", i),
        lambda i: step_side("off", i),
        n_steps,
    )

    def drift(scores: list[float]) -> tuple[float, float, float]:
        """(initial-window mean, final-window mean, drift) over the
        first/last 10% of samples (>= 1 sample each)."""
        w = max(1, len(scores) // 10)
        first = sum(scores[:w]) / w
        last = sum(scores[-w:]) / w
        return round(first, 4), round(last, 4), round(first - last, 4)

    on_h = sides["on"]
    on_first, on_last, on_drift = drift(track["on"]["scores"])
    off_first, off_last, off_drift = drift(track["off"]["scores"])
    evictions = on_h.cluster.metrics.counter(
        "grove_defrag_evictions_total"
    ).total()
    evictions_per_hour = evictions / hours
    mig = on_h.cluster.metrics.counter(
        "grove_scheduler_migration_bind_total"
    )
    mig_hits = mig.value(outcome="hit")
    mig_attempts = mig.total()
    moves = on_h.cluster.metrics.counter("grove_defrag_moves_total")
    verdicts = {
        ls["verdict"]: int(moves.value(**ls))
        for ls in moves.label_sets()
    }
    # the what-if contract, measured: engine launches attributable to
    # defrag AFTER its first sweep must contain no full re-encode
    steady = {
        k: v - whatif_baseline.get("kinds", {}).get(k, 0)
        for k, v in on_h.defrag.dispatch_kinds.items()
    }
    full_reencodes = (
        steady.get("state_full_uploads", 0)
        + steady.get("fused", 0)
        + steady.get("split", 0)
    )

    failures = []
    if on_drift > args.defrag_band:
        failures.append(
            f"on-side drift {on_drift} exceeds band {args.defrag_band}"
        )
    if off_drift <= args.defrag_band or off_last >= on_last:
        failures.append(
            f"vacuous A/B: off-side drift {off_drift} within the band "
            f"(or off final {off_last} >= on final {on_last}) — the "
            "churn never fragmented the fleet"
        )
    if evictions_per_hour > evict_bound + 1e-9:
        failures.append(
            f"migration cost: {evictions_per_hour:.1f} evictions/hour "
            f"over the {evict_bound:g} bound"
        )
    if mig_attempts == 0:
        failures.append(
            "zero migration-ticket binds: make-before-break never "
            "exercised — vacuous coverage"
        )
    if full_reencodes:
        failures.append(
            f"what-if contract: {full_reencodes} full re-encode(s) "
            f"attributable to defrag sweeps in the steady-state window "
            f"(attribution: {steady})"
        )

    out = {
        "metric": "continuous defragmentation: long-churn drift A/B "
        f"({hours:g} virtual hours, {num_nodes} nodes, "
        f"{trios} trio + {pairs} pair + {solos} fill gangs)",
        "value": on_drift,
        "unit": "placement-score drift (defrag on)",
        "vs_baseline": off_drift,
        "defrag_steps": n_steps,
        "defrag_step_seconds": step,
        "defrag_band": args.defrag_band,
        "score_on_initial": on_first,
        "score_on_final": on_last,
        "score_on_drift": on_drift,
        "score_off_initial": off_first,
        "score_off_final": off_last,
        "score_off_drift": off_drift,
        "defrag_sweeps": on_h.defrag.sweeps_total,
        "defrag_moves": on_h.defrag.moves_total,
        "move_verdicts": verdicts,
        "evictions_per_hour": round(evictions_per_hour, 2),
        "evictions_per_hour_bound": evict_bound,
        "migration_bind_attempts": int(mig_attempts),
        "migration_bind_hits": int(mig_hits),
        "make_before_break_hit_rate": (
            round(mig_hits / mig_attempts, 3) if mig_attempts else 0.0
        ),
        "defrag_dispatch_attribution_steady": steady,
        "whatif_path": (
            on_h.defrag.debug_state()["last_sweep"] or {}
        ).get("whatif"),
        **wall_stats(track["on"]["walls"], "defrag_on_step_"),
        **wall_stats(track["off"]["walls"], "defrag_off_step_"),
        "backend": backend_name(device),
        "engine": "single",
    }
    for f in failures:
        print(f"DEFRAG BENCH FAILURE: {f}", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failures else 0
