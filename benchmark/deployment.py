"""A configuration's cluster and gangs, worked out from its JSON file alone.

Nothing here imports the program: the node names, labels and capacities,
the topology levels and the gang shapes are what the benchmark hands to
both the program (through `benchmark.system`) and the plain reference
(`benchmark.reference`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def load_json(path) -> dict:
    with open(ROOT / path) as f:
        return json.load(f)


@dataclass
class GangSpec:
    """One gang as the benchmark states it: P pods over R resources, its
    pod groups and pack levels (indices into the configuration's levels,
    broadest first; -1 = none)."""

    name: str
    demand: np.ndarray                 # f32 [P, R]
    group_ids: np.ndarray              # i32 [P]
    group_names: list[str]
    group_required: np.ndarray         # i32 [groups]
    group_preferred: np.ndarray        # i32 [groups]
    required: int = -1
    preferred: int = -1
    priority: float = 0.0
    fairness: float = 0.0
    kind: str = ""

    @property
    def num_pods(self) -> int:
        return int(self.demand.shape[0])


@dataclass
class Deployment:
    """The configuration's inventory: node names, per-level labels, the
    capacity matrix and the gang mix."""

    config: dict
    resources: list[str]
    node_names: list[str]
    labels: list[list[str]]            # [levels][nodes], broadest first
    capacity: np.ndarray               # f32 [N, R]
    level_names: list[str]
    pod: np.ndarray                    # f32 [R]
    mix: list[dict] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    def level(self, domain: str | None) -> int:
        return -1 if domain is None else self.level_names.index(domain)

    def slots(self) -> int:
        """Pods of the configuration's shape the cluster holds."""
        per_node = np.floor(np.min(
            self.capacity / np.maximum(self.pod, 1e-9)[None, :], axis=1))
        return int(per_node.sum())

    def pods_per_gang(self) -> float:
        total = sum(m["weight"] for m in self.mix)
        return sum(m["weight"] * sum(g["pods"] for g in m["groups"])
                   for m in self.mix) / total

    def gang(self, name: str, kind: dict, pod=None) -> GangSpec:
        """A gang of mix entry `kind`, every pod of shape `pod` (default:
        the configuration's)."""
        pod = self.pod if pod is None else np.asarray(pod, np.float32)
        groups = kind["groups"]
        sizes = [g["pods"] for g in groups]
        return GangSpec(
            name=name,
            demand=np.tile(pod, (sum(sizes), 1)).astype(np.float32),
            group_ids=np.repeat(np.arange(len(groups), dtype=np.int32), sizes),
            group_names=[g["name"] for g in groups],
            group_required=np.array([self.level(g.get("required"))
                                     for g in groups], np.int32),
            group_preferred=np.array([self.level(g.get("preferred"))
                                      for g in groups], np.int32),
            required=self.level(kind.get("required")),
            preferred=self.level(kind.get("preferred")),
            kind=kind["kind"],
        )

    def draw_kinds(self, rng: np.random.Generator, count: int) -> np.ndarray:
        """The mix entries of `count` gangs, in exact proportion (every draw
        holds the same set of shapes), in an order drawn from `rng`."""
        total = sum(m["weight"] for m in self.mix)
        counts = [count * m["weight"] // total for m in self.mix]
        counts[0] += count - sum(counts)
        kinds = np.repeat(np.arange(len(self.mix)), counts)
        return kinds[rng.permutation(count)]

    def backlog(self, prefix: str, kinds) -> list[GangSpec]:
        """The gangs of drawn `kinds`, named so they sort in draw order
        (one spec a mix entry, its arrays shared)."""
        templates = [self.gang("", kind) for kind in self.mix]
        return [replace(templates[k], name=f"{prefix}-{i:05d}")
                for i, k in enumerate(kinds)]


def deployment(config: dict) -> Deployment:
    """The inventory a configuration file states. Node i's label at level
    k is the level's `label` template filled with i's index inside each
    enclosing level (`nodes` a domain, broadest first)."""
    nodes = config["nodes"]
    alloc = nodes["allocatable"]
    resources = list(alloc)
    n = nodes["count"]
    idx = np.arange(n)
    locals_ = []
    parent = None
    for lv in config["levels"]:
        inner = idx if parent is None else idx % parent
        locals_.append(inner // lv["nodes"])
        parent = lv["nodes"]
    labels = []
    for k, lv in enumerate(config["levels"]):
        cols = locals_[: k + 1]
        labels.append([lv["label"].format(*(int(c[i]) for c in cols))
                       for i in range(n)])
    capacity = np.tile(np.array([alloc[r] for r in resources], np.float32),
                       (n, 1))
    pod = np.array([config["pod"].get(r, 0.0) for r in resources], np.float32)
    return Deployment(
        config=config,
        resources=resources,
        node_names=[nodes["name"].format(index=i) for i in range(n)],
        labels=labels,
        capacity=capacity,
        level_names=[lv["domain"] for lv in config["levels"]],
        pod=pod,
        mix=config["gangs"],
    )
