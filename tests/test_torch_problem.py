"""The encode from PodGangs: grove_tpu_torch's `encode_podgangs` against
the JAX package's, on the same seeded clusters and backlogs built in
each package (`Twin`, shared with tests/test_torch_solver.py and
tests/test_torch_observability.py).

Every SolverGang field is held equal, exactly: demands, pod names, group
ids, names and levels, required and preferred levels (UNRESOLVED_LEVEL for
an unknown required key, -1 for an unknown preferred one), priority,
constraint groups, the unschedulable reason (message and UnsatCode) and
the per-pod eligibility masks, element for element, None where the pod
is unconstrained, with the same sharing (`dedupe_pod_masks` gives the
same rows and indices). The backlogs include the min_replicas cut (pods
beyond it are not encoded) and a gang with a missing pod (skipped).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from grove_tpu_torch.observability.explain import UnsatCode


class Twin(SimpleNamespace):
    """One package's API, topology and solver modules, so a scenario is
    written once and built in either package."""


def package(root: str) -> Twin:
    api = importlib.import_module(root + ".api")
    return Twin(
        root=root,
        api=api,
        topology=importlib.import_module(root + ".topology"),
        solver=importlib.import_module(root + ".solver"),
        problem=importlib.import_module(root + ".solver.problem"),
    )


JAX = package("grove_tpu")
TORCH = package("grove_tpu_torch")
PACKAGES = (TORCH, JAX)

HOST = "kubernetes.io/hostname"


def engine(p: Twin, snap, **knobs):
    """The package's PlacementEngine; the port's on the CPU."""
    if p is TORCH:
        knobs.setdefault("device", "cpu")
    return p.solver.PlacementEngine(snap, **knobs)


def make_cluster(p: Twin, blocks=2, racks=2, hosts=2, cpu=8.0, mem=32.0,
                 tpu=4.0, labels=None, taints=None):
    """blocks x racks x hosts nodes with a block/rack topology (the host
    level appended); `labels(i)` / `taints(i)` add a node's extra labels
    and taint keys."""
    nodes = []
    i = 0
    for b in range(blocks):
        for r in range(racks):
            for h in range(hosts):
                lab = {"t/block": f"b{b}", "t/rack": f"b{b}r{r}"}
                lab.update(labels(i) if labels else {})
                nodes.append(p.api.Node(
                    metadata=p.api.ObjectMeta(name=f"n{b}{r}{h}", labels=lab),
                    allocatable={"cpu": cpu, "memory": mem, "tpu": tpu},
                    taints=list(taints(i)) if taints else [],
                ))
                i += 1
    ct = p.topology.default_cluster_topology([
        p.api.TopologyLevel(domain="block", key="t/block"),
        p.api.TopologyLevel(domain="rack", key="t/rack"),
    ])
    return p.topology.encode_topology(ct, nodes)


class Backlog:
    """PodGangs with their Pods, built in one package: `add` writes a
    gang; `encode` runs the package's encode_podgangs with the pods'
    requests as demand, their selector and tolerations as the node filter
    and each gang's priority."""

    def __init__(self, p: Twin, namespace: str = "default"):
        self.p = p
        self.ns = namespace
        self.podgangs = []
        self.pods = {}
        self.priority = {}

    @staticmethod
    def pack(p, required=None, preferred=None):
        if required is None and preferred is None:
            return None
        return p.api.TopologyConstraint(p.api.TopologyPackConstraint(
            required=required, preferred=preferred))

    def add(self, name, groups, required=None, preferred=None, priority=0.0,
            constraint_groups=(), missing=()):
        """groups: dicts of pods, min (min_replicas, default all), cpu,
        mem, tpu, required, preferred (label keys), selector, tolerations
        (the latter two per pod: a callable of the pod's index in the
        group, or a value for all). constraint_groups: (name, [group
        names], required key, preferred key). missing: pod names whose
        Pod is not created."""
        p = self.p
        pod_groups = []
        for gi, g in enumerate(groups):
            refs = []
            for j in range(g["pods"]):
                pod_name = f"{name}-g{gi}-p{j}"
                refs.append(p.api.NamespacedName(self.ns, pod_name))
                if pod_name in missing:
                    continue
                sel = g.get("selector", {})
                tol = g.get("tolerations", [])
                spec = p.api.PodSpec(
                    containers=[p.api.Container(name="c", resources={
                        "cpu": g.get("cpu", 1.0), "memory": g.get("mem", 1.0),
                        "tpu": g.get("tpu", 0.0)})],
                    node_selector=dict(sel(j) if callable(sel) else sel),
                    tolerations=list(tol(j) if callable(tol) else tol),
                )
                self.pods[(self.ns, pod_name)] = p.api.Pod(
                    metadata=p.api.ObjectMeta(name=pod_name, namespace=self.ns),
                    spec=spec)
            pod_groups.append(p.api.PodGroup(
                name=f"g{gi}", pod_references=refs,
                min_replicas=g.get("min", g["pods"]),
                topology_constraint=self.pack(p, g.get("required"),
                                              g.get("preferred"))))
        cgs = [p.api.TopologyConstraintGroupConfig(
            name=cname, pod_group_names=list(members),
            topology_constraint=self.pack(p, req, pref))
            for cname, members, req, pref in constraint_groups]
        self.podgangs.append(p.api.PodGang(
            metadata=p.api.ObjectMeta(name=name, namespace=self.ns),
            spec=p.api.PodGangSpec(
                pod_groups=pod_groups,
                topology_constraint=self.pack(p, required, preferred),
                topology_constraint_group_configs=cgs)))
        self.priority[name] = priority
        return self

    def encode(self, snap):
        names = snap.resource_names

        def pod_demand(ns, name):
            pod = self.pods.get((ns, name))
            if pod is None:
                return None
            req = pod.spec.total_requests()
            return np.asarray([req.get(r, 0.0) for r in names], np.float32)

        def pod_scheduling(ns, name):
            spec = self.pods[(ns, name)].spec
            return spec.node_selector, spec.tolerations

        return self.p.problem.encode_podgangs(
            self.podgangs, snap, pod_demand,
            priority_of=lambda pg: self.priority[pg.metadata.name],
            pod_scheduling=pod_scheduling)


LEVEL_KEYS = ("t/block", "t/rack", HOST, "t/nosuch")


def seeded_problem(p: Twin, seed: int, gangs: int = 16, taints=True):
    """A seeded cluster (3 blocks x 2 racks x 3 hosts, an accel label on
    some nodes, a taint on some) and backlog built in package `p`: 1-2
    groups of 1-4 pods each, min_replicas cuts, random demands, levels
    drawn from the topology's keys and one it lacks, priorities,
    selectors and tolerations on some pods, constraint groups, and one
    gang with a missing pod."""
    rng = np.random.default_rng(seed)
    accel = {i for i in range(18) if rng.random() < 0.4}
    tainted = {i for i in range(18) if rng.random() < (0.2 if taints else 0)}
    snap = make_cluster(
        p, blocks=3, racks=2, hosts=3, cpu=16.0, mem=64.0, tpu=8.0,
        labels=lambda i: {"accel": "v5"} if i in accel else {},
        taints=lambda i: ["maint"] if i in tainted else [])

    def level():
        return LEVEL_KEYS[int(rng.integers(0, 4))] if rng.random() < 0.6 else None

    backlog = Backlog(p)
    for gi in range(gangs):
        groups = []
        for _ in range(int(rng.integers(1, 3))):
            pods = int(rng.integers(1, 5))
            sel_pod = int(rng.integers(0, pods)) if rng.random() < 0.4 else -1
            tol = rng.random() < 0.5
            groups.append({
                "pods": pods, "min": int(rng.integers(1, pods + 1)),
                "cpu": float(rng.integers(1, 5)),
                "mem": float(rng.integers(1, 9)),
                "tpu": float(rng.integers(0, 3)),
                "required": level() if rng.random() < 0.3 else None,
                "preferred": level() if rng.random() < 0.3 else None,
                "selector": (lambda j, s=sel_pod:
                             {"accel": "v5"} if j == s else {}),
                "tolerations": ["maint"] if tol else [],
            })
        cgs = ()
        if len(groups) == 2 and rng.random() < 0.5:
            cgs = (("cg", ["g0", "g1"], level(), level()),)
        missing = ()
        if gi == gangs // 2:
            missing = (f"g{gi:03d}-g0-p0",)
        backlog.add(f"g{gi:03d}", groups, required=level(),
                    preferred=level(), priority=float(rng.integers(0, 3)),
                    constraint_groups=cgs, missing=missing)
    return snap, backlog


FIELDS = ("name", "namespace", "pod_names", "group_names", "required_level",
          "preferred_level", "priority", "fairness", "constraint_groups")
ARRAYS = ("demand", "group_ids", "group_required_level",
          "group_preferred_level")


def assert_gangs_equal(ours, ref):
    """Field-by-field equality of two packages' SolverGang lists."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.name, f)
        ra, rb = a.unschedulable_reason, b.unschedulable_reason
        assert (ra is None) == (rb is None), a.name
        if ra is not None:
            assert str(ra) == str(rb) and ra.code.value == rb.code.value
        assert (a.pod_elig is None) == (b.pod_elig is None), a.name
        if a.pod_elig is not None:
            for ma, mb in zip(a.pod_elig, b.pod_elig, strict=True):
                assert (ma is None) == (mb is None), a.name
                if ma is not None:
                    assert np.array_equal(ma, mb) and not ma.flags.writeable


@pytest.mark.parametrize("taints", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_encode_podgangs_matches_the_jax_package(seed, taints):
    snap, backlog = seeded_problem(TORCH, seed, taints=taints)
    jsnap, jbacklog = seeded_problem(JAX, seed, taints=taints)
    ours, ref = backlog.encode(snap), jbacklog.encode(jsnap)
    assert_gangs_equal(ours, ref)
    # the gang with a missing pod is skipped by both
    assert len(ours) == len(backlog.podgangs) - 1
    rows, idx = TORCH.problem.dedupe_pod_masks(ours)
    jrows, jidx = JAX.problem.dedupe_pod_masks(ref)
    assert np.array_equal(idx, jidx)
    assert len(rows) == len(jrows)
    assert all(np.array_equal(a, b) for a, b in zip(rows, jrows))


def test_seeded_problems_cover_every_rule():
    """The seeds above reach each rule: masks, UNRESOLVED_LEVEL, a
    dropped preferred level, a min_replicas cut and constraint groups."""
    seen = set()
    for seed in range(6):
        snap, backlog = seeded_problem(TORCH, seed)
        gangs = {g.name: g for g in backlog.encode(snap)}
        for pg in backlog.podgangs:
            g = gangs.get(pg.metadata.name)
            if g is None:
                seen.add("skipped")
                continue
            refs = sum(len(x.pod_references) for x in pg.spec.pod_groups)
            if g.num_pods < refs:
                seen.add("min cut")
            if g.pod_elig is not None:
                seen.add("masks")
            if g.required_level == TORCH.problem.UNRESOLVED_LEVEL:
                seen.add("unresolved")
                assert g.unschedulable_reason.code is UnsatCode.UNRESOLVED_LEVEL
            tc = pg.spec.topology_constraint
            if (tc is not None and tc.pack_constraint.preferred == "t/nosuch"):
                assert g.preferred_level == -1
                seen.add("dropped preferred")
            if g.constraint_groups:
                seen.add("constraint groups")
    assert seen == {"skipped", "min cut", "masks", "unresolved",
                    "dropped preferred", "constraint groups"}


@pytest.mark.parametrize("p", PACKAGES, ids=lambda p: p.root)
def test_pod_eligibility_mask_rules(p):
    """None for an unconstrained pod, for a cluster without taints and no
    selector, and for a mask that excludes nothing; a shared read-only
    mask otherwise, equal across the packages."""
    snap = make_cluster(p, labels=lambda i: {"accel": "v5"} if i % 2 else {},
                        taints=lambda i: ["maint"] if i == 0 else [])
    mask = p.problem.pod_eligibility_mask
    assert mask(snap, None, True) is None
    assert mask(snap, ({}, ["maint"]), True) is None
    got = mask(snap, ({"accel": "v5"}, []), True)
    assert got is snap.eligibility({"accel": "v5"}, [])
    want = np.array([i % 2 == 1 for i in range(8)])
    assert np.array_equal(got, want)
    assert np.array_equal(mask(snap, ({}, []), True),
                          np.arange(8) != 0)


def test_stress_podgangs_equal_the_stress_gangs():
    """stress.make_podgangs encoded is stress.make_gangs, field by field
    (chip_smoke.py's podgang phase relies on it)."""
    from grove_tpu_torch import stress

    snap = stress.make_cluster(512)
    podgangs, pods = stress.make_podgangs(24)
    assert_gangs_equal(stress.encode_stress_podgangs(snap, podgangs, pods),
                       stress.make_gangs(24))
