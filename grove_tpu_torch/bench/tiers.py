"""The hierarchical scale-tier regime (`--scale-tier 20k|100k`): the
counterpart of bench.py's `bench_scale_tier`."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..solver import PlacementEngine
from .shapes import (
    backend_name,
    interleaved_ab,
    make_tier_cluster,
    make_tier_gangs,
    p50,
    regime_device,
    wall_stats,
)

#: --scale-tier regimes: nodes / gangs. 20k mirrors the scale4x probe's
#: size on the 4-level topology (flat A/B still feasible); 100k is the
#: ROADMAP tier whose flat tensor does not fit.
_TIERS = {"20k": (20_000, 4_000), "100k": (100_000, 20_000)}

#: past roughly this many value-tensor entries (G_pad x D, f32) the flat
#: engine's device matrices stop fitting CI-class hosts — the flat A/B
#: side is SKIPPED (loudly) above it rather than OOM-killed
_FLAT_TENSOR_CEILING = 2.5e8


def bench_scale_tier(args, device=None) -> int:
    """The hierarchical scale-tier regime (--scale-tier 20k|100k): a
    block-confined backlog over the synthetic 4-level topology, solved
    by the two-level engine with a dirty tick per repeat (a few gangs
    replaced) so the SHARD-LOCAL incremental tier genuinely runs —
    clean domains ride the domain-reuse memo / sub-engine reuse, dirty
    domains re-score O(dirty) rows — and the dispatch-kind counters
    prove it. Interleaved A/B/C: the wave-parallel engine (dispatch-all
    then collect-in-order fine solves, --wave-workers) vs the SERIAL
    fine phase (workers=0) vs the flat engine where its tensor still
    fits, with a phase wall breakdown (coarse / fine-solve /
    exactness-net + per-domain fine-wall spread) in the JSON;
    min/median/max over repeats because this class of host throttles
    hard run-to-run. On a >= 2-device mesh the wave side's fine-phase
    median must beat the serial side's (exit nonzero otherwise)."""
    device = regime_device(args, device)
    from ..observability import MetricsRegistry
    from ..solver.engine import _bucket

    num_nodes, num_gangs = _TIERS[args.scale_tier]
    if args.small:
        # CI-friendly miniature of the same shape (still 4-level, still
        # hierarchical): the regime's mechanics, not its scale
        num_nodes, num_gangs = 8_192, 1_024
        print(
            f"bench --small: clamping --scale-tier {args.scale_tier} to "
            f"{num_nodes} nodes / {num_gangs} gangs",
            file=sys.stderr,
        )
    snapshot = make_tier_cluster(num_nodes)
    gangs = make_tier_gangs(num_gangs)
    registry = MetricsRegistry()

    #: --trace composition: the wave and serial engines each trace into
    #: their own group (own Perfetto process), so the export shows the
    #: dispatch-all/collect-in-order overlap against the one-domain-at-
    #: a-time serial fine phase side by side, with the causal flow
    #: arrows (engine.hierarchical -> per-domain engine.fine_solve)
    #: linking each coarse assignment to its fine solves. Walls measured
    #: under --trace carry the tracing overhead — not record numbers.
    trace_groups: dict = {}
    if args.trace:
        from ..observability.tracing import Tracer

        trace_groups = {"wave": Tracer(), "serial": Tracer()}

    if args.sharded:
        from ..parallel import (
            ShardedPlacementEngine,
            initialize_multihost,
            make_solver_mesh,
        )

        initialize_multihost(device=device)
        mesh = make_solver_mesh(device=device)

        def mk(**kw):
            return ShardedPlacementEngine(snapshot, mesh, device=device, **kw)
    else:
        mesh = None

        def mk(**kw):
            return PlacementEngine(snapshot, device=device, **kw)

    hier = mk(hierarchical=True, metrics=registry,
              hier_parallel_workers=args.wave_workers,
              **({"tracer": trace_groups["wave"]} if trace_groups
                 else {}))
    # solver microbench: decision-ring recording off (the documented
    # opt-out) — at 20k gangs/solve the ring's LRU churn is a visible
    # constant the deployed path amortizes across its cluster-owned log
    hier.decisions = None
    # the wave-parallel A/B side: the SAME hierarchical engine pinned to
    # the serial one-domain-at-a-time fine phase (workers=0), solving
    # the identical backlog sequence interleaved — the fine-phase
    # speedup is the dispatch-all/collect-in-order overlap, nothing
    # else. Its own registry, so both sides pay the identical per-gang
    # metrics recording (an asymmetry here skews the bind-wall fields)
    hier_serial = mk(hierarchical=True, hier_parallel_workers=0,
                     metrics=MetricsRegistry(),
                     **({"tracer": trace_groups["serial"]} if trace_groups
                        else {}))
    hier_serial.decisions = None
    DIRTY = 8

    def dirty_tick(backlog, tick):
        """Replace DIRTY gangs with fresh content UNDER THE SAME sort
        position (name-adjacent successor): the control plane's churn
        shape — a rebuilt replica keeps its identity — so a tick
        dirties its gangs' own domains instead of shifting every
        gang's position in the sorted order (which would re-chunk the
        whole coarse assignment and invalidate every domain). The
        positions are SPREAD one per backlog stride: fleet churn lands
        across blocks, not clustered in one, so a tick dirties ~DIRTY
        distinct domains — which is also what gives the wave-parallel
        A/B real concurrent fine solves to overlap (a clustered tick
        dirties 1-2 domains and measures nothing)."""
        out = list(backlog)
        stride = max(1, len(out) // DIRTY)
        for j in range(DIRTY):
            pos = (j * stride + tick) % len(out)
            g = make_tier_gangs(1)[0]
            g.name = out[pos].name.split(".")[0] + f".{tick}"
            out[pos] = g
        return out

    # flat A/B feasibility: G_pad x D value tensor (the [N, D]
    # membership product behind it is bigger still)
    num_domains = 1 + int(np.asarray(snapshot.num_domains).sum())
    flat_entries = _bucket(num_gangs) * num_domains
    flat_ok = flat_entries <= _FLAT_TENSOR_CEILING
    # the flat A/B side keeps its incremental tier ON (the deployed
    # default): every timed repeat is a DIRTY tick, so the flat engine
    # legitimately re-scores O(dirty) rows too — unlike the scale2x/4x
    # probes' identical repeats, pinning incremental off here would
    # compare hier-with-incrementality against a flat config nobody
    # deploys and overstate the win
    flat = mk(hierarchical=False) if flat_ok else None

    # warm-up: compile + device-resident state + sub-engine population,
    # plus one untimed dirty tick so the incremental program's shapes
    # compile OUTSIDE the timed window (every bench here excludes
    # compile; the first-ever dirty tick would otherwise carry it)
    backlog = list(gangs)
    hier.solve(backlog, free=snapshot.free.copy())
    hier_serial.solve(backlog, free=snapshot.free.copy())
    backlog = dirty_tick(backlog, -1)
    hier.solve(backlog, free=snapshot.free.copy())
    hier_serial.solve(backlog, free=snapshot.free.copy())

    state = {"backlog": backlog, "placed": 0}
    #: per-side phase walls (hier_coarse / fine-solve / exactness-net
    #: seconds per repeat) + per-domain fine-wall spread + wave width —
    #: the breakdown that names WHICH phase regressed, not just the p50
    phase_keys = ("hier_coarse_seconds", "hier_fine_seconds",
                  "hier_net_seconds")
    track = {
        side: {"phases": {k: [] for k in phase_keys},
               "dom_min": [], "dom_med": [], "dom_max": [],
               "width": 0}
        for side in ("wave", "serial")
    }

    def record(side, res):
        t = track[side]
        for k in phase_keys:
            t["phases"][k].append(res.stats.get(k, 0.0))
        t["dom_min"].append(res.stats.get("hier_fine_wall_min", 0.0))
        t["dom_med"].append(res.stats.get("hier_fine_wall_med", 0.0))
        t["dom_max"].append(res.stats.get("hier_fine_wall_max", 0.0))
        t["width"] = max(t["width"],
                         int(res.stats.get("hier_wave_width", 0)))

    def run_side(side, eng):
        t0 = time.perf_counter()
        res = eng.solve(state["backlog"], free=snapshot.free.copy())
        wall = time.perf_counter() - t0
        state["placed"] = res.num_placed
        record(side, res)
        return wall

    def run_pair(rep):
        """One dirty tick, then the wave and serial sides back-to-back
        in ALTERNATING order, so any load burst mid-pair lands on both
        sides across the repeat set rather than always on the same
        one."""
        state["backlog"] = dirty_tick(state["backlog"], rep)
        if rep % 2:
            s_wall = run_side("serial", hier_serial)
            w_wall = run_side("wave", hier)
        else:
            w_wall = run_side("wave", hier)
            s_wall = run_side("serial", hier_serial)
        return w_wall, s_wall

    repeats = max(args.tier_repeats, 3)
    # phase A: the wave-vs-serial pair, tight back-to-back and NOTHING
    # in between — the flat engine's much larger solve leaves a
    # cache/thermal wake that would land on whichever side follows it
    # (measured ~4x on this host class), drowning the ~2x effect under
    # measurement; even repeat count so the alternating order splits
    # any residual order bias evenly
    pair_walls = [run_pair(rep) for rep in range(repeats + repeats % 2)]
    h_walls = [w for w, _s in pair_walls]
    s_walls = [s for _w, s in pair_walls]

    # phase B: the historical hierarchical-vs-flat A/B (where the flat
    # tensor is still materializable), classic interleave. The wave
    # engine keeps ticking the same backlog stream; its phase-B walls
    # feed only the flat comparison (a 50-100x ratio that tolerates
    # the wake), never the wave-vs-serial medians above.
    def run_hier_flat(rep):
        state["backlog"] = dirty_tick(state["backlog"], 1000 + rep)
        t0 = time.perf_counter()
        state["placed"] = hier.solve(
            state["backlog"], free=snapshot.free.copy()
        ).num_placed
        return time.perf_counter() - t0

    def run_flat(_rep):
        if flat is None:
            return None
        t0 = time.perf_counter()
        flat.solve(state["backlog"], free=snapshot.free.copy())
        return time.perf_counter() - t0

    if flat is not None:
        # the flat warm-up (compile + device state; at this tier a
        # much larger solve than anything hierarchical) runs HERE, not
        # before phase A — its cache/thermal wake must never land on a
        # timed wave-vs-serial sample
        flat.solve(state["backlog"], free=snapshot.free.copy())
        hf_walls, f_walls = interleaved_ab(run_hier_flat, run_flat,
                                           repeats)
        f_walls = [w for w in f_walls if w is not None]
    else:
        hf_walls, f_walls = [], []

    # phase C (--engine pallas): the kernel tiers on the FINE phase — two
    # fresh hierarchical engines (device commit on vs off; on the card
    # the value kernel runs on both, on the CPU the B side is the plain
    # arithmetic, as bench.py's XLA side) over the same dirty-ticked
    # backlog stream, back-to-back per tick, comparing the per-solve
    # hier_fine_seconds. The B side's keys are host_commit_fine_*
    # (bench.py: xla_fine_*).
    pallas_fine = {}
    if args.engine == "pallas":
        hp = mk(hierarchical=True, hier_parallel_workers=args.wave_workers,
                pallas_core=True, device_commit=True)
        hx = mk(hierarchical=True, hier_parallel_workers=args.wave_workers,
                device_commit=False)
        hp.decisions = None
        hx.decisions = None
        for eng in (hp, hx):  # warm: compile + shards + one dirty tick
            eng.solve(state["backlog"], free=snapshot.free.copy())
        state["backlog"] = dirty_tick(state["backlog"], 2000)
        for eng in (hp, hx):
            eng.solve(state["backlog"], free=snapshot.free.copy())
        fine_c = {"pallas": [], "host_commit": []}

        def run_kernel_side(side, eng):
            res = eng.solve(state["backlog"], free=snapshot.free.copy())
            fine_c[side].append(res.stats.get("hier_fine_seconds", 0.0))

        for rep in range(repeats + repeats % 2):
            state["backlog"] = dirty_tick(state["backlog"], 2001 + rep)
            order = (("pallas", hp), ("host_commit", hx))
            for side, eng in (order if rep % 2 == 0 else order[::-1]):
                run_kernel_side(side, eng)
        hp_ds = hp.debug_summary()["device_state"]
        pallas_fine = {
            "pallas_fine_ab": {
                "kernel_tier": hp_ds["core_tier"],
                "pallas_interpret": hp_ds["pallas_interpret"],
                "pallas_dispatches": hp_ds["dispatches"].get("pallas", 0),
                "device_commit_dispatches": hp_ds["dispatches"].get(
                    "device_commit", 0
                ),
                "pallas_fallbacks": hp_ds["pallas_fallbacks"],
                **wall_stats(fine_c["pallas"], "pallas_fine_"),
                **wall_stats(fine_c["host_commit"], "host_commit_fine_"),
                "fine_device_speedup": round(
                    p50(fine_c["host_commit"])
                    / max(p50(fine_c["pallas"]), 1e-9),
                    3,
                ),
                "interleaved": True,
            }
        }
    placed = state["placed"]
    ds = hier.debug_summary()
    disp = ds["device_state"]["dispatches"]
    hier_block = ds["hierarchical"]
    failures = []
    if disp.get("incremental", 0) == 0:
        failures.append(
            "coverage: the shard-local incremental tier never ran — the "
            "dirty ticks should have re-scored O(dirty) rows per "
            "affected domain"
        )
    if hier_block["last_pruned_pairs"] == 0 and hier_block["shards_built"] <= 1:
        failures.append(
            "coverage: the coarse level neither pruned nor partitioned "
            "anything — the tier ran effectively flat"
        )
    wave_workers = hier_block["wave_workers"]
    wave_fine = track["wave"]["phases"]["hier_fine_seconds"]
    serial_fine = track["serial"]["phases"]["hier_fine_seconds"]
    fine_speedup = round(p50(serial_fine) / max(p50(wave_fine), 1e-9), 2)
    if wave_workers >= 1 and track["wave"]["width"] < 2:
        failures.append(
            "coverage: the wave-parallel fine phase never dispatched a "
            "multi-domain wave — the wave A/B is vacuous"
        )
    local_devices = len(mesh.local_devices) if mesh is not None else 1
    if pallas_fine:
        pab = pallas_fine["pallas_fine_ab"]
        if pab["kernel_tier"] != "xla" and pab["pallas_dispatches"] == 0:
            failures.append(
                "coverage: --engine pallas fine phase never launched the "
                "kernel tier — the pallas A/B is vacuous"
            )
    if wave_workers >= 1 and local_devices >= 2 and fine_speedup <= 1.0:
        # the mesh gate (ROADMAP item 1 follow-up): with the domains
        # round-robined across >= 2 devices, dispatch-all/collect-in-
        # order must beat one-domain-at-a-time on the fine phase median
        # (single-device runs report the ratio without gating — there
        # the overlap is host-vs-device only and throttling noise on
        # this host class swings walls ~2x)
        failures.append(
            f"wave-parallel fine-phase speedup {fine_speedup} <= 1 on a "
            f"{local_devices}-device mesh — the wave overlap bought "
            "nothing"
        )
    tier_p50 = p50(h_walls)
    out = {
        "metric": f"hierarchical scale tier ({num_gangs} x 8-pod gangs, "
        f"{num_nodes} nodes, 4-level topology)",
        "value": round(num_gangs / tier_p50, 1),
        "unit": "gangs/sec",
        # flat comparison against the phase-B hier walls measured in
        # the SAME interleave as the flat side (never phase A's)
        "vs_baseline": round(
            (p50(f_walls) / p50(hf_walls)), 2
        ) if f_walls else 0.0,
        "tier": args.scale_tier,
        "placed": placed,
        **wall_stats(h_walls, "tier_", suffix="backlog_bind_seconds"),
        "tier_sub_second_p50": tier_p50 < 1.0,
        "tier_repeats": len(h_walls),
        "tier_dirty_gangs_per_tick": DIRTY,
        # phase wall breakdown (wave side): a future regression names
        # the PHASE — coarse assignment, fine solves, or the serial
        # exactness net — plus the per-domain fine-wall spread naming
        # whether one slow domain or the whole wave moved
        "phase_breakdown": {
            **wall_stats(track["wave"]["phases"]["hier_coarse_seconds"],
                         "coarse_"),
            **wall_stats(wave_fine, "fine_solve_"),
            **wall_stats(track["wave"]["phases"]["hier_net_seconds"],
                         "exactness_net_"),
            "domain_fine_wall_min_seconds": round(
                min(track["wave"]["dom_min"]), 4
            ),
            "domain_fine_wall_median_seconds": round(
                p50(track["wave"]["dom_med"]), 4
            ),
            "domain_fine_wall_max_seconds": round(
                max(track["wave"]["dom_max"]), 4
            ),
        },
        # wave-parallel vs serial fine phase, interleaved (the same
        # dirty-ticked backlogs back-to-back; ranges reported because
        # this host class throttles ~2x run-to-run)
        "wave_parallel_ab": {
            "wave_workers": wave_workers,
            "wave_width_max": track["wave"]["width"],
            **wall_stats(wave_fine, "wave_fine_"),
            **wall_stats(serial_fine, "serial_fine_"),
            **wall_stats(s_walls, "serial_",
                         suffix="backlog_bind_seconds"),
            "fine_phase_speedup_p50": fine_speedup,
            "bind_speedup_p50": round(p50(s_walls) / tier_p50, 2),
            "interleaved": True,
        },
        **pallas_fine,
        "dispatches_by_kind": dict(disp),
        "incremental_rows": ds["device_state"]["incremental_rows"],
        "reuse_hits": ds["device_state"]["reuse_hits"],
        "hier_prune_level": hier_block["prune_level"],
        "hier_coarse_domains": hier_block["coarse_domains"],
        "hier_shards_built": hier_block["shards_built"],
        "hier_last_pruned_pairs": hier_block["last_pruned_pairs"],
        "flat_ab": (
            {
                **wall_stats(f_walls, "flat_"),
                "interleaved": True,
            }
            if f_walls
            else f"skipped: flat [G_pad x D] = {flat_entries:.2e} "
            "value-tensor entries exceeds the materializable ceiling "
            f"({_FLAT_TENSOR_CEILING:.0e}) — the wall the hierarchy "
            "removes"
        ),
        "engine": "sharded" if args.sharded else "single",
        **({"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
           if mesh is not None else {}),
        **({"traced": True} if trace_groups else {}),
        "backend": backend_name(device),
    }
    if args.trace:
        from ..observability.tracing import chrome_trace

        with open(args.trace, "w") as fh:
            json.dump(chrome_trace(trace_groups), fh)
            fh.write("\n")
        n_spans = sum(len(v.finished) for v in trace_groups.values())
        print(f"wrote {n_spans} spans to {args.trace}", file=sys.stderr)
    for f in failures:
        print(f"SCALE-TIER FAILURE: {f}", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failures else 0
