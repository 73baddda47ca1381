"""The system under test: the port, built from a configuration.

Everything the benchmark takes from `grove_tpu_torch` goes through here:
its Node and ClusterTopology objects, the snapshot, the placement engine,
the Harness, its Tracer, and one observation hook (`Recorder`) that keeps,
for a sample of the solves drawn from the seed, what the solve handed to
its exact repair -- the device phase's packed result and the free state
it was scored against -- and its value tensor, so that the reference can
judge what the timed path produced. The hook changes nothing the engine
computes.
"""

from __future__ import annotations

import numpy as np

from .deployment import Deployment, GangSpec


def nodes_and_topology(dep: Deployment):
    """(Node list, ClusterTopology) of the deployment, as the program
    holds them."""
    from grove_tpu_torch.api.meta import ObjectMeta
    from grove_tpu_torch.api.types import Node, TopologyLevel
    from grove_tpu_torch.topology.encoding import default_cluster_topology

    levels = dep.config["levels"]
    alloc = {r: float(c) for r, c in zip(dep.resources, dep.capacity[0])}
    nodes = [
        Node(metadata=ObjectMeta(
                 name=name,
                 labels={lv["key"]: dep.labels[k][i]
                         for k, lv in enumerate(levels)}),
             allocatable=dict(alloc))
        for i, name in enumerate(dep.node_names)
    ]
    topology = default_cluster_topology(
        [TopologyLevel(domain=lv["domain"], key=lv["key"]) for lv in levels])
    return nodes, topology


def snapshot(dep: Deployment):
    from grove_tpu_torch.topology.encoding import encode_topology

    nodes, topology = nodes_and_topology(dep)
    snap = encode_topology(topology, nodes)
    if list(snap.resource_names) != dep.resources:
        raise RuntimeError(f"the snapshot orders resources "
                           f"{list(snap.resource_names)}, the configuration "
                           f"{dep.resources}")
    return snap


def solver_gang(spec: GangSpec, name: str | None = None):
    """The program's gang for `spec` (under `name` where given), sharing
    the spec's arrays."""
    from grove_tpu_torch.solver import SolverGang

    name = spec.name if name is None else name
    return SolverGang(
        name=name, namespace="bench", demand=spec.demand,
        pod_names=[f"{name}-p{j}" for j in range(spec.num_pods)],
        group_ids=spec.group_ids, group_names=spec.group_names,
        group_required_level=spec.group_required,
        group_preferred_level=spec.group_preferred,
        required_level=spec.required, preferred_level=spec.preferred,
        priority=spec.priority,
    )


def spec_of(gang) -> GangSpec:
    """A GangSpec read off a program SolverGang (for solves the program
    encoded itself, from its PodGangs)."""
    return GangSpec(
        name=gang.name, demand=np.asarray(gang.demand, np.float32),
        group_ids=np.asarray(gang.group_ids, np.int32),
        group_names=list(gang.group_names),
        group_required=np.asarray(gang.group_required_level, np.int32),
        group_preferred=np.asarray(gang.group_preferred_level, np.int32),
        required=int(gang.required_level), preferred=int(gang.preferred_level),
        priority=float(gang.priority), fairness=float(gang.fairness))


def engine_kwargs(config: dict, device) -> dict:
    e = config["engine"]
    kw = dict(device=device, top_k=e["top_k"], commit_chunk=e["commit_chunk"],
              pallas_precision=e["pallas_precision"], fused=e["fused"],
              incremental=e["incremental"], device_commit=e["device_commit"],
              hierarchical=e["hierarchical"])
    if device is not None and str(device) == "cpu":
        kw["pallas_core"] = True       # the kernels' plain versions
    return kw


def harness_config(config: dict, tracing: bool, device=None) -> dict:
    e = config["engine"]
    out = {
        "solver": {
            "top_k": e["top_k"], "commit_chunk": e["commit_chunk"],
            "hierarchical_solve": e["hierarchical"],
            "pallas_precision": e["pallas_precision"],
            "fused_solve": e["fused"], "incremental_resolve": e["incremental"],
            "device_commit": e["device_commit"],
        },
        "tracing": {"enabled": bool(tracing)},
    }
    if device is not None and str(device) == "cpu":
        out["solver"]["pallas_core"] = True    # the kernels' plain versions
    return out


class Record:
    """One sampled solve: the engine's node order and resources, the gangs
    in the order its exact repair took them, the free state that repair
    was handed, the device phase's committed (value, domain) rows, the
    placements, the value tensor (K1's output) and, where the driver keeps
    one, its own view of the cluster taken as the solve began (`view`)."""

    __slots__ = ("engine", "names", "resources", "order", "free", "top_val",
                 "top_dom", "placed", "value", "view", "unit")

    def __init__(self, engine, unit, view):
        self.engine = engine
        self.names = engine.snapshot.node_names
        self.resources = list(engine.snapshot.resource_names)
        self.unit = unit
        self.view = view
        self.order = self.free = self.top_val = self.top_dom = None
        self.placed = self.value = None


def _value_rows(engine, g: int):
    """The value tensor [G, D] (K1's output, before the tie jitter) of the
    solve that just ran, from the engine's resident cache: on the fused
    and incremental paths it holds that solve's rows in sorted order until
    the next solve. None where the engine keeps no cache."""
    inc = getattr(engine, "_inc", None)
    if inc is None or inc.value_dev is None:
        return None
    return inc.value_dev[:g].float().cpu().numpy()


class Recorder:
    """Keeps a Record of a uniform sample of `k` of the solves made while
    `on`, drawn from `seed` by reservoir sampling (so the sample needs no
    count of the solves in advance); nothing is kept of the others. Inside
    a sampled solve it copies the free state and the committed rows; the
    value tensor and the placements are copied by `take_value`, which the backlog driver calls
    once the solve's wall is read and which runs at the end of `solve`
    where `value_at_return` is set. `view`, where given, is called as a
    sampled solve begins and its answer kept on the record."""

    def __init__(self, k: int, seed: int, view=None,
                 value_at_return: bool = False):
        self.k = k
        self.rng = np.random.default_rng([seed, 1])
        self.view = view
        self.value_at_return = value_at_return
        self.on = False
        self.seen = 0
        self.kept: list[Record] = []
        self.current: Record | None = None

    @property
    def records(self) -> list[Record]:
        """The sampled solves, in the order they ran."""
        return sorted((r for r in self.kept if r.order is not None),
                      key=lambda r: r.unit)

    def begin(self, engine) -> None:
        unit, self.seen = self.seen, self.seen + 1
        self.current = None
        if len(self.kept) >= self.k:
            j = int(self.rng.integers(0, unit + 1))
            if j >= self.k:
                return
            self.kept.pop(j)
        rec = Record(engine, unit,
                     self.view() if self.view is not None else None)
        self.kept.append(rec)
        self.current = rec

    def take_value(self) -> None:
        """Copy the sampled solve's value tensor off the card; the solve
        must be the last its engine ran."""
        rec, self.current = self.current, None
        if rec is not None and rec.order is not None:
            rec.value = _value_rows(rec.engine, len(rec.order))
            rec.placed = {name: np.array(p.node_indices, np.int64)
                          for name, p in rec.placed.items()}

    def repaired(self, engine, order, top_val, top_dom, free) -> Record | None:
        rec = self.current
        if rec is None or rec.engine is not engine:
            return None
        rec.order = list(order)
        rec.free = np.array(free, np.float32, copy=True)
        rec.top_val = np.array(top_val, copy=True)
        rec.top_dom = np.array(top_dom, copy=True)
        return rec

    def values_from_inputs(self) -> int:
        """For sampled solves whose engine kept no value tensor, the value
        tensor its public `score_values` gives on the same gangs and free
        state (K1 on the recorded inputs); call after the window, before
        the engines are released. Returns how many."""
        n = 0
        for rec in self.records:
            if rec.value is None:
                value = rec.engine.score_values(rec.order, rec.free)[0]
                rec.value = value[: len(rec.order)].float().cpu().numpy()
                n += 1
        return n


def engine_class(recorder: Recorder, base=None):
    """`base` (default the port's PlacementEngine) with a uniform sample of
    its solves recorded by `recorder`."""
    if base is None:
        from grove_tpu_torch.solver import PlacementEngine as base

    class Recorded(base):
        def solve(self, gangs, *args, **kwargs):
            if not recorder.on:
                return super().solve(gangs, *args, **kwargs)
            recorder.begin(self)
            out = super().solve(gangs, *args, **kwargs)
            if recorder.value_at_return:
                recorder.take_value()
            return out

        def _repair(self, order, top_val, top_dom, free):
            rec = recorder.repaired(self, order, top_val, top_dom, free)
            out = super()._repair(order, top_val, top_dom, free)
            if rec is not None:
                rec.placed = out[0]      # copied by take_value
            return out

    return Recorded
