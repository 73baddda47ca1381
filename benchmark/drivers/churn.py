"""Steady arrivals through the whole control plane, as an open loop on the
wall clock (`Harness`: ControllerManager -> GangScheduler -> engine ->
store).

The mix is the churn workload of the program's bench (arrivals, deletions
beyond a population, scale events, a crash and recovery, a canary's
rolling update), rewritten as an open loop: single-replica PodCliqueSets
of the configuration's gang kind are due at fixed times, a Poisson
process at `rate_gangs_per_s` (the same set of gaps for every seed, in an
order drawn from the seed); the oldest beyond `population` are deleted; a
standing set is scaled by +-`scale_step` replicas every `scale_every_s`,
one of its pods crashes or recovers every `crash_every_s`, and a canary's
template flips every `canary_every_s`. The virtual clock follows the wall
clock. Each turn of the loop creates what is due, advances the clock,
settles the plane and looks at the gangs still pending: a gang's bind
latency runs from when it was due to when the benchmark sees its PodGang
Scheduled, so a stall delays no arrival and counts for every gang behind
it. After the window the plane keeps settling, without arrivals, until
every gang due in the window is bound or `grace_s` has passed; a gang
never bound counts with the wait it had, and one deleted before its bind
with the wait it had then. Only a gang never bound counts as failed.

The reference then checks every Scheduled PodGang in the store against
the guarantees (bound whole, on nodes whose allocatable holds every bound
pod, inside one domain of the required level) and re-solves a sample of
the window's engine solves, drawn from the seed. As a sampled solve
begins, the benchmark reads the store's pods; its own ledger of free
capacity for that solve is the nodes' allocatable less the requests of
every pod bound, not terminal and not being deleted (kube-scheduler's
accounting). The reference re-solves the gangs the program handed its
repair from that ledger, each gang held to the PodCliqueSet template it
came from, and counts the node rows where the free state the program
handed its repair differs from the ledger. The mix sets no reservation
and no migration, so the scheduler holds no bind in flight outside the
store when it solves.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from .. import readers, reference, system
from ..deployment import deployment
from ..profile import DeviceTrace
from ..stats import quantile, rate, tail
from .common import GcPauses, Outcome, release_device


def arrival_times(rng, rate_per_s: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): round(rate * seconds) arrivals whose gaps
    are the quantiles of the exponential distribution of a Poisson process
    at `rate_per_s`, scaled to end inside the window (the same set and
    count for every seed), in an order drawn from `rng`."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate_per_s
    gaps *= seconds * n / (n + 1) / gaps.sum()
    return np.cumsum(gaps[rng.permutation(n)])


def _pcs(name: str, replicas: int, kind: dict, requests: dict):
    from grove_tpu_torch.api.meta import ObjectMeta
    from grove_tpu_torch.api.types import (
        Container, PodCliqueSet, PodCliqueSetSpec, PodCliqueSetTemplateSpec,
        PodCliqueSpec, PodCliqueTemplateSpec, PodSpec, TopologyConstraintSpec,
        TopologyPackConstraintSpec)

    (group,) = kind["groups"]
    return PodCliqueSet(
        metadata=ObjectMeta(name=name),
        spec=PodCliqueSetSpec(
            replicas=replicas,
            template=PodCliqueSetTemplateSpec(
                cliques=[PodCliqueTemplateSpec(
                    name=group["name"][:1],
                    spec=PodCliqueSpec(
                        replicas=group["pods"],
                        pod_spec=PodSpec(containers=[Container(
                            name="m", resources=dict(requests))])))],
                topology_constraint=TopologyConstraintSpec(
                    pack_constraint=TopologyPackConstraintSpec(
                        required=kind.get("required"),
                        preferred=kind.get("preferred"))))))


def _pods(store) -> list:
    """The store's pods as they are now. The store replaces an object on
    every write and never changes one it holds, so the objects read here
    stay as they were."""
    from grove_tpu_torch.api.types import Pod

    return list(store.kind_bucket(Pod.KIND).values())


def free_ledger(dep, pods) -> np.ndarray:
    """The nodes' allocatable less the requests of every pod of `pods`
    bound to a node, not terminal and not being deleted (kube-scheduler's
    accounting), [N, R] in the deployment's node order."""
    index = {name: i for i, name in enumerate(dep.node_names)}
    ledger = dep.capacity.astype(np.float64)
    col = {r: j for j, r in enumerate(dep.resources)}
    for p in pods:
        if (not p.node_name or p.metadata.deletion_timestamp is not None
                or p.status.phase in ("Succeeded", "Failed")):
            continue
        i = index[p.node_name]
        for c in p.spec.containers:
            for r, v in c.resources.items():
                if r in col:
                    ledger[i, col[r]] -= v
    return ledger.astype(np.float32)


class _Plane:
    """The Harness under the open loop, and the bookkeeping of arrivals."""

    def __init__(self, h, dep, traffic, kind):
        self.h = h
        self.dep = dep
        self.tr = traffic
        self.kind = kind
        self.requests = {r: float(v) for r, v in zip(dep.resources, dep.pod)}
        self.canary_requests = dict(self.requests)
        self.canary_requests["cpu"] = self.requests["cpu"] - 1.0
        self.alive: deque = deque()
        self.pending: dict[str, float] = {}   # gang -> due (perf_counter)
        self.latency: dict[str, float] = {}   # gang -> seconds, bound
        self.cut: dict[str, float] = {}       # gang -> wait, deleted unbound
        self.bound_at: dict[str, float] = {}
        self.crashed = None
        self.scale_dir = 1
        self.events = {"scale": 0, "crash": 0, "recover": 0, "canary": 0}

    def arrive(self, name: str, due_abs: float) -> None:
        from grove_tpu_torch.api.naming import base_podgang_name

        self.h.apply(_pcs(name, 1, self.kind, self.requests))
        self.alive.append(name)
        self.pending[base_podgang_name(name, 0)] = due_abs
        while len(self.alive) > self.tr["population"]:
            victim = self.alive.popleft()
            self.h.store.delete("PodCliqueSet", "default", victim)
            due = self.pending.pop(base_podgang_name(victim, 0), None)
            if due is not None:
                self.cut[base_podgang_name(victim, 0)] = time.perf_counter() - due

    def scale(self) -> None:
        pcs = self.h.store.get("PodCliqueSet", "default", "standing")
        pcs.spec.replicas += self.tr["scale_step"] * self.scale_dir
        self.scale_dir = -self.scale_dir
        self.h.store.update(pcs)
        self.events["scale"] += 1

    def crash_or_recover(self) -> None:
        from grove_tpu_torch.api import constants
        from grove_tpu_torch.api.types import Pod

        if self.crashed is not None:
            self.h.kubelet.recover_pod("default", self.crashed)
            self.crashed = None
            self.events["recover"] += 1
            return
        for p in self.h.store.scan(
                Pod.KIND, labels={constants.LABEL_PART_OF: "standing"}):
            if p.status.ready:
                self.crashed = p.metadata.name
                self.h.kubelet.crash_pod("default", self.crashed)
                self.events["crash"] += 1
                return

    def flip_canary(self) -> None:
        pcs = self.h.store.get("PodCliqueSet", "default", "canary")
        c = pcs.spec.template.cliques[0].spec.pod_spec.containers[0]
        cpu = c.resources.get("cpu")
        c.resources = dict(c.resources, cpu=(
            self.canary_requests["cpu"] if cpu == self.requests["cpu"]
            else self.requests["cpu"]))
        self.h.store.update(pcs)
        self.events["canary"] += 1

    def observe(self) -> int:
        """Move the pending gangs the store shows Scheduled to `latency`;
        returns how many."""
        from grove_tpu_torch.api.meta import get_condition
        from grove_tpu_torch.api.podgang import PodGang, PodGangConditionType

        now = time.perf_counter()
        bucket = self.h.store.kind_bucket(PodGang.KIND)
        done = []
        for name, due in self.pending.items():
            gang = bucket.get(("default", name))
            if gang is None:
                continue
            cond = get_condition(gang.status.conditions,
                                 PodGangConditionType.SCHEDULED.value)
            if cond is not None and cond.status == "True":
                done.append(name)
                self.latency[name] = now - due
                self.bound_at[name] = now
        for name in done:
            del self.pending[name]
        return len(done)


def run(config, traffic, limits, seed, seconds, trace, device=None,
        mark_window=lambda: None, base_engine=None) -> Outcome:
    from grove_tpu_torch.api.config import load_operator_config
    from grove_tpu_torch.cluster.cluster import Cluster
    from grove_tpu_torch.controller import Harness
    from grove_tpu_torch.solver import programs
    from grove_tpu_torch.tuning import tune_gc

    dep = deployment(config)
    kind = next(m for m in dep.mix if m["kind"] == traffic["gang_kind"])
    rng = np.random.default_rng(seed)
    nodes, topology = system.nodes_and_topology(dep)
    cluster = Cluster(nodes=nodes, topology=topology,
                      config=load_operator_config(system.harness_config(
                          config, tracing=trace, device=device)))
    # the window's solves the reference re-solves, drawn from the seed,
    # each with the store's pods as it began
    recorder = system.Recorder(traffic["check_solves"], seed,
                               view=lambda: _pods(cluster.store),
                               value_at_return=True)
    h = Harness(cluster=cluster, device=device,
                engine_cls=system.engine_class(recorder, base_engine))
    plane = _Plane(h, dep, traffic, kind)
    h.apply(_pcs("standing", traffic["standing_replicas"], kind, plane.requests))
    h.apply(_pcs("canary", traffic["canary_replicas"], kind, plane.requests))
    h.settle()
    # warm-up: the loop itself at the cell's rate, then one burst of each
    # bucket size up to warm_max_gangs, deleted again
    _loop(plane, "w", arrival_times(rng, traffic["rate_gangs_per_s"],
                                    traffic["warm_seconds"]),
          traffic["warm_seconds"], None, events=False)
    size = 8
    while size <= traffic["warm_max_gangs"]:
        names = [f"l{size}-{i}" for i in range(size)]
        for name in names:
            h.apply(_pcs(name, 1, kind, plane.requests))
        h.settle()
        for name in names:
            h.store.delete("PodCliqueSet", "default", name)
        h.settle()
        size *= 2
    h.compact_events()
    plane.pending.clear()
    plane.latency.clear()
    plane.cut.clear()
    plane.bound_at.clear()
    tune_gc()
    due = arrival_times(rng, traffic["rate_gangs_per_s"], seconds)
    caps0 = programs.capture_counts()
    recorder.on = True
    tracer = h.cluster.tracer
    dt = DeviceTrace(trace, tracer)
    spans = []
    gc_pauses = GcPauses()
    mark_window()
    with dt, gc_pauses:
        turns, lag = _loop(plane, "a", due, seconds, dt, spans=spans,
                           trace=trace)
    window_s = dt.window_s
    t_close = dt.t0 + window_s
    bound_in_window = sum(1 for t in plane.bound_at.values() if t <= t_close)
    caps = {p: c - caps0.get(p, 0) for p, c in programs.capture_counts().items()}
    # a minute past the close, without arrivals, for the gangs still due
    recorder.on = False
    t_grace = time.perf_counter() + traffic["grace_s"]
    while plane.pending and time.perf_counter() < t_grace:
        h.clock.advance(0.05)
        h.settle()
        plane.observe()
    missing = [time.perf_counter() - d for d in plane.pending.values()]
    waits = list(plane.latency.values())
    out = Outcome()
    unbound = missing + list(plane.cut.values())
    out.metrics = {"bound_gangs_per_s": rate(bound_in_window, window_s),
                   "bind_p99_s": tail(waits, unbound, 0.99)}
    # a gang the mix deleted before its bind was withdrawn by its user, not
    # failed by the plane: above capacity how many that is follows the
    # host's speed, and is printed below; failed is what never bound
    out.attempted = len(due)
    out.failed = len(missing)
    out.notes += [
        f"window: {window_s:.3f} s, {len(due)} gangs due at "
        f"{traffic['rate_gangs_per_s']} gangs/s, {turns} loop turns, "
        f"{bound_in_window} bound in the window",
        f"bind latency from due, {len(waits)} bound: "
        + ", ".join(f"p{int(q * 100)} {tail(waits, unbound, q):.4f} s"
                    for q in (0.5, 0.9, 0.95, 0.99))
        + f"; {len(plane.cut)} deleted before their bind, "
        f"{len(missing)} never bound",
        f"generator lag: median {quantile(lag, 0.5):.4f} s, max "
        f"{max(lag):.4f} s (how late each arrival was created)" if lag else
        "generator lag: no arrivals",
        f"events in the window: {plane.events}",
        f"graph captures in the window: {caps}",
        gc_pauses.note(),
    ]
    out.extra["captures_in_window"] = caps
    if trace:
        tr = dt.read(spans)
        in_window = [s for s in spans if s.t1 is not None]
        out.traced = readers.TracedRun(
            kernels=tr["kernels"], busy_s=tr["busy_s"], window_s=window_s,
            spans=in_window, bound=bound_in_window)
        out.trace = tr
    out.memory_peak_bytes = release_device(device)
    derived = recorder.values_from_inputs()
    if derived:
        out.notes.append(f"reference: the engine kept no value tensor; "
                         f"{derived} taken from score_values")
    out.checks = _judge(dep, config, h, plane, recorder.records, limits,
                        out.notes)
    h.release_engines()
    return out


def _loop(plane, prefix, due, seconds, dt, events=True, spans=None,
          trace=False):
    """The open loop over `due` (seconds from its start) until `seconds`;
    returns (turns, each arrival's lag behind its due time)."""
    h, tr = plane.h, plane.tr
    t0 = time.perf_counter()
    v_last = 0.0
    i, turns, lag = 0, 0, []
    next_ev = {"scale": tr["scale_every_s"], "crash": tr["crash_every_s"],
               "canary": tr["canary_every_s"]}
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        while i < len(due) and due[i] <= now:
            plane.arrive(f"{prefix}{i}", t0 + due[i])
            lag.append(time.perf_counter() - t0 - due[i])
            i += 1
        if events:
            for ev, act in (("scale", plane.scale),
                            ("crash", plane.crash_or_recover),
                            ("canary", plane.flip_canary)):
                if now >= next_ev[ev]:
                    act()
                    next_ev[ev] += tr[f"{ev}_every_s"]
        h.clock.advance(max(0.0, now - v_last))
        v_last = now
        if dt is not None:
            with dt.range("bench.settle"):
                h.settle()
        else:
            h.settle()
        h.compact_events()
        plane.observe()
        if trace:
            spans.extend(h.cluster.tracer.finished)
            h.cluster.tracer.finished.clear()
        turns += 1
    return turns, lag


def _judge(dep, config, h, plane, records, limits, notes):
    from grove_tpu_torch.api.meta import get_condition
    from grove_tpu_torch.api.podgang import PodGang, PodGangConditionType
    from grove_tpu_torch.api.types import Pod

    index = {name: i for i, name in enumerate(dep.node_names)}
    used = np.zeros_like(dep.capacity)
    pods = {}
    for p in h.store.scan(Pod.KIND):
        node = p.node_name
        if node:
            req = p.spec.total_requests()
            used[index[node]] += [req.get(r, 0.0) for r in dep.resources]
            pods[(p.metadata.namespace, p.metadata.name)] = index[node]
    violations = int(np.sum(np.any(used > dep.capacity + 1e-6, axis=1)))
    required = dep.level(next(m for m in dep.mix
                              if m["kind"] == plane.tr["gang_kind"])
                         .get("required"))
    labels = np.array(dep.labels[required]) if required >= 0 else None
    scheduled = 0
    for gang in h.store.scan(PodGang.KIND):
        cond = get_condition(gang.status.conditions,
                             PodGangConditionType.SCHEDULED.value)
        if cond is None or cond.status != "True":
            continue
        scheduled += 1
        nodes = []
        for group in gang.spec.pod_groups:
            bound = [pods[(r.namespace, r.name)] for r in group.pod_references
                     if (r.namespace, r.name) in pods]
            if len(bound) < group.min_replicas:
                violations += 1
            nodes += bound
        if labels is not None and len(set(labels[nodes])) > 1:
            violations += 1
    # the re-solve of the sampled solves, and their gangs against the
    # templates they came from
    gap, dom_mis, place_mis, encode_mis, checked = 0.0, 0, 0, 0, 0
    label_of = {name: [lv[i] for lv in dep.labels]
                for i, name in enumerate(dep.node_names)}
    e = config["engine"]
    kind = next(m for m in dep.mix if m["kind"] == plane.tr["gang_kind"])
    shapes = [dep.pod, np.array([plane.canary_requests[r]
                                 for r in dep.resources], np.float32)]
    want = dep.gang("", kind)
    sampled = [r for r in records if r.value is not None]
    free_mis = 0
    t0 = time.perf_counter()
    for rec in sampled:
        if rec.resources != dep.resources:
            encode_mis += 1
            continue
        names = list(rec.names)
        rows = np.array([index[n] for n in names])
        topo = reference.Topology(
            [[label_of[n][k] for n in names] for k in range(len(dep.labels))],
            names, dep.capacity[rows])
        ledger = free_ledger(dep, rec.view)[rows]
        free_mis += int(np.sum(np.any(np.abs(rec.free - ledger) > 1e-4,
                                      axis=1)))
        specs = [system.spec_of(g) for g in rec.order]
        for s in specs:
            ok = (s.num_pods == want.num_pods
                  and any(np.array_equal(s.demand, np.tile(p, (s.num_pods, 1)))
                          for p in shapes)
                  and s.required == want.required
                  and s.preferred == want.preferred
                  and np.array_equal(s.group_required, want.group_required)
                  and np.array_equal(s.group_preferred, want.group_preferred))
            encode_mis += not ok
        c = reference.compare_solve(topo, ledger, specs, rec.top_val,
                                    rec.top_dom, rec.placed, rec.value,
                                    e["top_k"], e["commit_chunk"],
                                    [g.name for g in rec.order])
        gap = max(gap, c["value_gap"])
        dom_mis += c["domain_mismatch"]
        place_mis += c["placement_mismatch"]
        checked += c["gangs"]
    notes.append(f"reference: {scheduled} Scheduled PodGangs checked for the "
                 f"guarantees, {len(sampled)} solves re-solved ({checked} "
                 f"gangs), {time.perf_counter() - t0:.1f} s")
    if not sampled:
        notes.append("reference: no sampled solve in the window")
        gap = 1e9
    return [("violations", violations, limits["violations"]),
            ("free_mismatch", free_mis, limits["free_mismatch"]),
            ("encode_mismatch", encode_mis, limits["encode_mismatch"]),
            ("value_gap", gap, limits["value_gap"]),
            ("domain_mismatch", dom_mis, limits["domain_mismatch"]),
            ("placement_mismatch", place_mis, limits["placement_mismatch"])]
