"""The multi-tenant regime (`--tenants N`): the counterpart of
bench.py's `bench_tenants`."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .controlplane import _churn_pcs
from .shapes import backend_name, regime_device


def bench_tenants(args, device=None) -> int:
    """Multi-tenant sustained-churn regime (`--tenants N`, ROADMAP item
    3's "millions of users" scenario): N tenant queues with guaranteed/
    burst cpu quota and equal DRF weight, driven by a Zipf-skewed gang
    arrival stream (tenant 0 offers ~an order of magnitude more load
    than the tail) against the full control plane with tenancy enabled.

    Asserts the fairness contract and exits nonzero on violation:
      - ZERO starved tenants: every tenant that offered load gets at
        least one gang bound (the guarantee band must hold under skew);
      - bounded fairness error: the max |dominant share - entitlement|
        over burst-eligible tenants, sampled every batch, stays under
        --fairness-bound (DRF must keep redistributing the burst band).

    Prints one JSON line (same shape as the other bench modes) carrying
    the per-tenant outcome distribution, shed counts and the sampled
    fairness-error peak."""
    device = regime_device(args, device)
    import collections

    from ..api.meta import get_condition
    from ..api.naming import base_podgang_name
    from ..api.podgang import PodGang, PodGangConditionType
    from ..cluster import make_nodes
    from ..controller import Harness
    from ..tuning import tune_gc

    T = args.tenants
    tenants = [f"t{i:03d}" for i in range(T)]
    # quota: every tenant is guaranteed 2 gangs' worth of cpu and may
    # burst to 5; the cluster itself has headroom, so sheds come from
    # QUOTA (the admission contract under test), not raw capacity
    gang_cpu = 8.0  # 8 pods x 1 cpu
    config = {
        "tenancy": {
            "enabled": True,
            "fairness_weight": 0.5,
            "tenants": [
                {
                    "name": t,
                    "guaranteed": {"cpu": 2 * gang_cpu},
                    "burst": {"cpu": 5 * gang_cpu},
                    "weight": 1.0,
                }
                for t in tenants
            ],
        }
    }
    h = Harness(
        device=device,
        nodes=make_nodes(
            args.nodes,
            allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
        ),
        config=config,
    )
    h.settle()
    tune_gc()

    rng = np.random.default_rng(11)
    batch_dt = 0.5
    n_arrivals = max(int(round(args.churn_rate * args.churn_duration)),
                     3 * T)
    # skewed offered load with full coverage: the first T arrivals hit
    # every tenant once (a tenant that never offers load cannot starve),
    # the rest draw Zipf — tenant 0 dominates the offered stream
    zipf_w = 1.0 / np.arange(1, T + 1, dtype=np.float64) ** 1.2
    zipf_w /= zipf_w.sum()
    sequence = list(rng.permutation(T)) + list(
        rng.choice(T, size=max(0, n_arrivals - T), p=zipf_w)
    )
    batch = max(1, int(round(args.churn_rate * batch_dt)))
    population = 4 * T

    alive: collections.deque[tuple[str, str]] = collections.deque()
    pending: dict[tuple[str, str], str] = {}  # (ns, gang) -> tenant
    created = collections.Counter()
    bound = collections.Counter()
    max_fairness_error = 0.0
    seq = 0
    t0 = time.perf_counter()

    def sample_bound() -> None:
        done = []
        for (ns, gname), tenant in pending.items():
            gang = h.store.peek(PodGang.KIND, ns, gname)
            if gang is None:
                continue
            cond = get_condition(
                gang.status.conditions,
                PodGangConditionType.SCHEDULED.value,
            )
            if cond is not None and cond.status == "True":
                bound[tenant] += 1
                done.append((ns, gname))
        for key in done:
            del pending[key]

    while sequence:
        for tenant_idx in sequence[:batch]:
            tenant = tenants[int(tenant_idx)]
            name = f"mt-{seq}"
            seq += 1
            pcs = _churn_pcs(name)
            pcs.metadata.namespace = tenant
            h.apply(pcs)
            alive.append((tenant, name))
            pending[(tenant, base_podgang_name(name, 0))] = tenant
            created[tenant] += 1
        sequence = sequence[batch:]
        while len(alive) > population:
            tenant, victim = alive.popleft()
            h.store.delete("PodCliqueSet", tenant, victim)
            pending.pop((tenant, base_podgang_name(victim, 0)), None)
        h.clock.advance(batch_dt)
        h.settle()
        h.compact_events()
        sample_bound()
        snapshot = h.cluster.topology_snapshot()
        h.cluster.tenancy.refresh_and_export(
            h.store, snapshot,
            h.cluster.pod_demand_fn(snapshot.resource_names),
        )
        max_fairness_error = max(
            max_fairness_error, h.cluster.tenancy.fairness_error()
        )
    # drain: fire the scheduler's quota-retry timers a few times so
    # gangs shed at peak skew get their post-churn admission chance
    for _ in range(4):
        h.advance(6.0)
        sample_bound()
    wall = time.perf_counter() - t0

    starved = sorted(
        t for t in tenants if created[t] > 0 and bound[t] == 0
    )
    sheds = h.cluster.metrics.counter("grove_tenant_gangs_shed_total")
    preempts = h.cluster.metrics.counter(
        "grove_tenant_preemption_evictions_total"
    )
    bound_counts = [bound[t] for t in tenants]
    out = {
        "metric": f"multi-tenant skewed churn ({T} tenants, "
        f"{args.nodes} nodes, Zipf offered load)",
        "value": round(sum(bound_counts) / wall, 1) if wall else 0.0,
        "unit": "gangs/sec",
        "vs_baseline": 0.0,
        "tenants": T,
        "tenants_offered": sum(1 for t in tenants if created[t] > 0),
        "tenants_starved": len(starved),
        "starved": starved[:8],
        "created": int(sum(created.values())),
        "bound": int(sum(bound_counts)),
        "unbound_final": len(pending),
        "sheds": int(sheds.total()),
        "preemption_evictions": int(preempts.total()),
        "bound_per_tenant_min": int(min(bound_counts)) if bound_counts else 0,
        "bound_per_tenant_max": int(max(bound_counts)) if bound_counts else 0,
        "max_fairness_error": round(max_fairness_error, 4),
        "fairness_bound": args.fairness_bound,
        "wall_seconds": round(wall, 2),
        "backend": backend_name(device),
        "engine": "single",
    }
    print(json.dumps(out))
    ok = not starved and max_fairness_error <= args.fairness_bound
    if starved:
        print(f"TENANT BENCH FAILURE: {len(starved)} starved tenant(s): "
              f"{starved[:8]}", file=sys.stderr)
    if max_fairness_error > args.fairness_bound:
        print(
            f"TENANT BENCH FAILURE: max fairness error "
            f"{max_fairness_error:.4f} > bound {args.fairness_bound}",
            file=sys.stderr,
        )
    return 0 if ok else 1
